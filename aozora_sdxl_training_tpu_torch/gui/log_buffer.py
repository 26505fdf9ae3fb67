"""Compressed scrollback log store for the GUI console.

Copy of ``aozora_sdxl_training_tpu/gui/log_buffer.py``, kept in the port so that the
port imports nothing of the JAX package.

Port of the reference's ``CompressedLogBuffer``
(the reference's gui/gui.py:576-871 semantics): append-only line log kept in
zlib-compressed blocks so multi-hour training consoles stay memory-bounded;
random access decompresses only the block containing the requested lines
(the virtual console renders just the visible window).
"""

from __future__ import annotations

import zlib


class CompressedLogBuffer:
    def __init__(self, block_lines: int = 512, compress_level: int = 6):
        self.block_lines = block_lines
        self.compress_level = compress_level
        self._blocks: list[bytes] = []        # compressed, immutable
        self._active: list[str] = []          # current uncompressed block
        self._total = 0

    def append(self, line: str) -> None:
        self._active.append(line)
        self._total += 1
        if len(self._active) >= self.block_lines:
            raw = "\n".join(self._active).encode("utf-8")
            self._blocks.append(zlib.compress(raw, self.compress_level))
            self._active = []

    def __len__(self) -> int:
        return self._total

    @property
    def compressed_bytes(self) -> int:
        return sum(len(b) for b in self._blocks)

    def _block(self, index: int) -> list[str]:
        if index < len(self._blocks):
            return zlib.decompress(self._blocks[index]).decode("utf-8").split("\n")
        return self._active

    def get_lines(self, start: int, count: int) -> list[str]:
        """Random access window; decompresses only the touched blocks."""
        start = max(0, start)
        end = min(self._total, start + count)
        out: list[str] = []
        index = start
        while index < end:
            block_idx = index // self.block_lines
            offset = index % self.block_lines
            block = self._block(block_idx)
            take = min(end - index, len(block) - offset)
            out.extend(block[offset:offset + take])
            index += take
        return out

    def tail(self, count: int) -> list[str]:
        return self.get_lines(max(0, self._total - count), count)
