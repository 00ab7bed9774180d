"""Seconds of staging: the host clock around the `QueryRunner`
constructor, ended by a synchronise (as chip_smoke.py::_query times it)."""


def read(run):
    return run["stage_s"]
