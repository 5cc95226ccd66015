"""Minimal dependency-free `.xls` writer (BIFF2 record stream).

Replaces the reference's `xlwt` dependency (infer.py:17, :75-78) for the
classification-results spreadsheet. BIFF2 is the simplest Excel binary
format that Excel/LibreOffice still open directly (no OLE2 container
required). Strings are limited to 255 bytes per cell — ample for
filename/label/confidence columns.

A copy of roomnet_tpu/utils/xls.py: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import struct


class Sheet:
    def __init__(self, name: str):
        self.name = name
        self._cells: dict[tuple[int, int], str] = {}

    def write(self, row: int, col: int, value) -> None:
        # Row cap is 0xFFFE, not 0xFFFF: the DIMENSIONS record packs
        # max_row+1 into a u16, so accepting row 0xFFFF here would pass
        # the write and then crash the whole workbook at save() time.
        if row < 0 or row > 0xFFFE or col < 0 or col > 0xFF:
            raise ValueError(f"cell out of BIFF2 range: ({row},{col})")
        self._cells[(row, col)] = str(value)


class Workbook:
    """xlwt-compatible surface: add_sheet / sheet.write / save."""

    def __init__(self):
        self._sheets: list[Sheet] = []

    def add_sheet(self, name: str) -> Sheet:
        sheet = Sheet(name)
        self._sheets.append(sheet)
        return sheet

    def save(self, path: str) -> None:
        if not self._sheets:
            raise ValueError("no sheets to save")
        # BIFF2 is single-sheet; first sheet wins (the reference writes one).
        sheet = self._sheets[0]
        out = bytearray()

        def record(opcode: int, data: bytes):
            out.extend(struct.pack("<HH", opcode, len(data)))
            out.extend(data)

        # BOF: version 0x0004 stream, type 0x0010 = worksheet.
        record(0x0009, struct.pack("<HH", 0x0004, 0x0010))
        if sheet._cells:
            max_row = max(r for r, _ in sheet._cells)
            max_col = max(c for _, c in sheet._cells)
            # DIMENSIONS (BIFF2): first/last+1 row (u16), first/last+1 col (u16).
            record(
                0x0000,
                struct.pack("<HHHH", 0, max_row + 1, 0, max_col + 1),
            )
        for (row, col), text in sorted(sheet._cells.items()):
            raw = text.encode("latin-1", errors="replace")[:255]
            # LABEL (BIFF2): row, col, 3 attribute bytes, length byte, text.
            record(
                0x0004,
                struct.pack("<HH3B", row, col, 0, 0, 0)
                + struct.pack("<B", len(raw))
                + raw,
            )
        record(0x000A, b"")  # EOF
        with open(path, "wb") as f:
            f.write(bytes(out))


def read_labels_biff2(path: str) -> dict[tuple[int, int], str]:
    """Parse LABEL cells back out of a BIFF2 file (for tests/round-trip)."""
    with open(path, "rb") as f:
        buf = f.read()
    cells = {}
    off = 0
    while off + 4 <= len(buf):
        opcode, length = struct.unpack_from("<HH", buf, off)
        off += 4
        data = buf[off : off + length]
        off += length
        if opcode == 0x0004:
            row, col = struct.unpack_from("<HH", data, 0)
            n = data[7]
            cells[(row, col)] = data[8 : 8 + n].decode("latin-1")
        elif opcode == 0x000A:
            break
    return cells
