"""MSB-first bit reader/writer for host-side bitstream protocol code
(AAC raw_data_block walking, SBR payload parse, encoder-lite serialization).
"""

import numpy as np


class BitReader:
    __slots__ = ("data", "pos", "nbits")

    def __init__(self, data: bytes, start_bit: int = 0):
        self.data = data
        self.pos = start_bit
        self.nbits = 8 * len(data)

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        if self.pos + n > self.nbits:
            raise EOFError(f"bitstream overrun at {self.pos}+{n}/{self.nbits}")
        v = 0
        pos = self.pos
        data = self.data
        for _ in range(n):
            v = (v << 1) | ((data[pos >> 3] >> (7 - (pos & 7))) & 1)
            pos += 1
        self.pos = pos
        return v

    def read1(self) -> int:
        pos = self.pos
        if pos >= self.nbits:
            raise EOFError("bitstream overrun")
        self.pos = pos + 1
        return (self.data[pos >> 3] >> (7 - (pos & 7))) & 1

    def skip(self, n: int):
        if self.pos + n > self.nbits:
            raise EOFError("bitstream overrun")
        self.pos += n

    def align(self):
        self.pos = (self.pos + 7) & ~7

    @property
    def bits_left(self) -> int:
        return self.nbits - self.pos


class BitWriter:
    __slots__ = ("bits",)

    def __init__(self):
        self.bits = []

    def write(self, val: int, n: int):
        bits = self.bits
        for i in range(n - 1, -1, -1):
            bits.append((val >> i) & 1)
        return self

    def align(self, bit: int = 0):
        while len(self.bits) % 8:
            self.bits.append(bit)
        return self

    def extend(self, other: "BitWriter"):
        self.bits.extend(other.bits)
        return self

    def __len__(self):
        return len(self.bits)

    def tobytes(self) -> bytes:
        bits = self.bits + [0] * (-len(self.bits) % 8)
        arr = np.asarray(bits, np.uint8).reshape(-1, 8)
        return bytes(np.packbits(arr, axis=1).reshape(-1).tobytes())


class Huffman:
    """Canonical (code, length) table decoder. Decode walks bit by bit
    through a nested dict keyed by (length, code) — tables here are ≤20 bits
    deep and host-side, so simplicity wins over LUT speed."""

    __slots__ = ("by_len", "max_len", "codes", "lens")

    def __init__(self, codes, lens):
        self.codes = [int(c) for c in codes]
        self.lens = [int(b) for b in lens]
        self.by_len = {}
        for idx, (c, l) in enumerate(zip(self.codes, self.lens)):
            self.by_len.setdefault(l, {})[c] = idx
        self.max_len = max(self.lens)

    def decode(self, br: BitReader) -> int:
        code = 0
        for length in range(1, self.max_len + 1):
            code = (code << 1) | br.read1()
            m = self.by_len.get(length)
            if m is not None and code in m:
                return m[code]
        raise ValueError(f"invalid huffman code {code:#x}")

    def encode(self, bw: BitWriter, idx: int):
        bw.write(self.codes[idx], self.lens[idx])
