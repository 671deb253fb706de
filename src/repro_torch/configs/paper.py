"""The paper's own experimental configuration (LCI, §5).

LCI is a communication library, so its "config" is the microbenchmark
matrix rather than a model: message sizes, lane (thread) counts, resource
modes, and the platform constants the evaluation used.  The mirror of
:mod:`repro.configs.paper` on the port's :class:`CommConfig`, so a
benchmark of either package reads each figure's parameters from one
definition.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from ..core.modes import CommConfig, CommMode


@dataclasses.dataclass(frozen=True)
class PaperBenchConfig:
    # Fig 2/3 — message rate: 8 B messages, 1..128 lanes ("threads")
    msg_rate_size: int = 8
    msg_rate_lanes: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128)
    msg_rate_iters: int = 2_000           # paper: 100k; scaled for CPU sim

    # Fig 4 — bandwidth: 64 lanes, 16 B .. 1 MiB
    bw_lanes: int = 64
    bw_sizes: Tuple[int, ...] = tuple(16 * 4 ** i for i in range(9))
    bw_iters: int = 50                    # paper: 1k; scaled

    # Fig 5 — individual resources: CQ / matching engine / packet pool
    resource_lanes: Tuple[int, ...] = (1, 4, 16, 64, 128)
    resource_iters: int = 5_000           # paper: 100k; scaled

    # Fig 6 — k-mer counting mini-app
    kmer_k: int = 11
    kmer_reads: int = 2_000
    kmer_read_len: int = 80
    kmer_ranks: Tuple[int, ...] = (2, 4, 8)
    kmer_agg_bytes: int = 8 * 1024        # paper: 8 KB aggregation buffers

    # Fig 7 — AMT pipeline (HPX/Octo-Tiger analogue): completion-graph
    # scheduled task DAG with comm edges
    amt_tasks: int = 256
    amt_ranks: int = 4

    # resource modes compared everywhere (paper's process/shared/dedicated)
    modes: Tuple[CommMode, ...] = (CommMode.BSP, CommMode.LCI_SHARED,
                                   CommMode.LCI_DEDICATED)


PAPER = PaperBenchConfig()


def comm_config(mode: CommMode, n_channels: int = 4) -> CommConfig:
    return CommConfig(mode=mode, n_channels=n_channels)
