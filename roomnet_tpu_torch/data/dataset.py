"""List files of labelled images (port of roomnet_tpu/data/dataset.py:32-35).

A list file holds ``<path> <label>`` lines; paths may contain spaces and
the label is the last token (reference generator.py:101-104).
"""

from __future__ import annotations


def parse_list_line(line: str) -> tuple[str, int]:
    """'<path with spaces> <label>\\n' -> (path, label) (generator.py:101-104)."""
    parts = line.strip().split(" ")
    return " ".join(parts[:-1]), int(parts[-1])
