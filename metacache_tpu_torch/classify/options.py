"""Query options and result accumulators: copies of the option classes
and ``ClassificationResults`` of metacache_tpu/classify/runner.py."""
from __future__ import annotations

import dataclasses
import sys
from typing import Dict

from ..config import ClassificationOptions, SketchingOptions
from ..seqio.reader import PairingMode
from ..taxonomy.model import Rank, Taxon
from .output import OutputFormatting
from .stats import ClassificationStatistics


# copied from metacache_tpu/classify/runner.py:131-199
@dataclasses.dataclass
class AnalysisOptions:
    """Reference: classification_analysis_options (src/options.hpp)."""
    show_top_hits: bool = False
    show_all_hits: bool = False
    show_locations: bool = False
    show_hits_per_target: bool = False
    target_mappings_file: str = ""
    show_tax_abundances: bool = False
    abundance_file: str = ""
    abundance_per: Rank = Rank.NONE
    show_alignment: bool = False


@dataclasses.dataclass
class EvaluationOptions:
    precision: bool = False
    taxon_coverage: bool = False
    # -ground-truth sets both; -precision/-taxon-coverage only determine
    # (reference: options.cpp:1093-1112 — showGroundTruth is a separate
    # flag from determineGroundTruth)
    determine_ground_truth: bool = False
    show_ground_truth: bool = False


@dataclasses.dataclass
class OutputOptions:
    format: OutputFormatting = dataclasses.field(
        default_factory=OutputFormatting)
    analysis: AnalysisOptions = dataclasses.field(
        default_factory=AnalysisOptions)
    evaluate: EvaluationOptions = dataclasses.field(
        default_factory=EvaluationOptions)

    # convenience accessors used by the formatting layer
    @property
    def show_ground_truth(self):
        return self.evaluate.show_ground_truth

    @property
    def show_all_hits(self):
        return self.analysis.show_all_hits

    @property
    def show_top_hits(self):
        return self.analysis.show_top_hits

    @property
    def show_locations(self):
        return self.analysis.show_locations


@dataclasses.dataclass
class QueryOptions:
    sketching: SketchingOptions | None = None    # None -> use database's
    classify: ClassificationOptions = dataclasses.field(
        default_factory=ClassificationOptions)
    pairing: PairingMode = PairingMode.NONE
    output: OutputOptions = dataclasses.field(default_factory=OutputOptions)
    batch_windows: int = 4096
    num_replicas: int = 1      # -replicate: data-parallel devices (0=all)
    table_shards: int = 1      # -table-shards: feature-range DB shards
    query_limit: int = -1
    min_read_length: int = 0
    max_read_length: int = 0   # 0 = unlimited
    num_threads: int = 1
    show_summary: bool = True
    show_query_params: bool = True


# copied from metacache_tpu/classify/runner.py:2367-2379
class ClassificationResults:
    def __init__(self, per_read_out=None, per_target_out=None,
                 per_taxon_out=None, status=None):
        self.per_read_out = per_read_out or sys.stdout
        self.per_target_out = per_target_out or self.per_read_out
        self.per_taxon_out = per_taxon_out or self.per_read_out
        self.status = status or sys.stderr
        self.statistics = ClassificationStatistics()
        self.tax_counts: Dict[Taxon, float] = {}
        self.tgt_matches: Dict[int, list] = {}
        self.saved_mappings: list = []
        self.query_count = 0
        self.time_ms = 0.0
