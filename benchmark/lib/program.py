"""The program's pieces that every architecture shares: its span and
counter registry, which the per-layer readers take spans and counters
from. A model's configuration and classifier are its architecture's
(benchmark/arch/<arch>/program.py).
"""

from __future__ import annotations


def spans() -> dict:
    """The program's span and counter registry, summarized."""
    from roomnet_tpu_torch.utils.profiling import SPANS

    return SPANS.summary()
