"""The probe stage's share of its roofline (see _roofline.py)."""
import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "bench_roofline", os.path.join(os.path.dirname(__file__), "_roofline.py"))
_r = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_r)


def read(run):
    return _r.share(run, "probe")
