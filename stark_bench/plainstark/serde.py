"""ark-serialize-compatible byte (de)serialization.

Byte layouts follow ark-serialize 0.4 exactly so emitted proof files match the
reference's `(claim, proof)` persistence format (src/proof.rs:43-120,
examples/brainfuck/main.rs:149-157):

* fixed-width ints: little-endian (u8/u16/u32/u64);
* usize: as u64 LE;
* bool / Option tag: single byte 0/1;
* Vec<T> and [T] slices: u64 LE length prefix + items;
* field elements: canonical LE bytes (8 for Fp, 24 for Fq3 as c0||c1||c2);
* digests (`SerdeOutput<Sha256>`): serialized via the inner byte slice =
  u64 length prefix (32) + 32 raw bytes (src/utils.rs:553-582).
"""

from __future__ import annotations

import io

from .fields.scalar import Fp, Fq3


class Writer:
    def __init__(self):
        self.buf = io.BytesIO()

    def bytes(self) -> bytes:
        return self.buf.getvalue()

    def raw(self, b: bytes):
        self.buf.write(b)

    def u8(self, v: int):
        self.buf.write(bytes([v & 0xFF]))

    def u32(self, v: int):
        self.buf.write((v & 0xFFFFFFFF).to_bytes(4, "little"))

    def u64(self, v: int):
        self.buf.write((v & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little"))

    def usize(self, v: int):
        self.u64(v)

    def boolean(self, v: bool):
        self.u8(1 if v else 0)

    def field(self, v):
        self.buf.write(v.to_bytes())

    def digest(self, d: bytes):
        assert len(d) == 32
        self.u64(32)
        self.buf.write(d)

    def vec(self, items, write_item):
        self.u64(len(items))
        for it in items:
            write_item(self, it)

    def field_vec(self, items):
        self.vec(items, lambda w, v: w.field(v))

    def digest_vec(self, items):
        self.vec(items, lambda w, d: w.digest(d))


    def option(self, v, write_item):
        if v is None:
            self.boolean(False)
        else:
            self.boolean(True)
            write_item(self, v)


class Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def raw(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + n]
        if len(b) != n:
            raise EOFError("unexpected end of proof bytes")
        self.pos += n
        return b

    def u8(self) -> int:
        return self.raw(1)[0]

    def u32(self) -> int:
        return int.from_bytes(self.raw(4), "little")

    def u64(self) -> int:
        return int.from_bytes(self.raw(8), "little")

    def usize(self) -> int:
        return self.u64()

    def boolean(self) -> bool:
        v = self.u8()
        assert v in (0, 1)
        return v == 1

    def fp(self) -> Fp:
        return Fp.from_bytes(self.raw(8))


    def field(self, field_cls):
        return field_cls.from_bytes(self.raw(field_cls.NUM_BYTES))

    def digest(self) -> bytes:
        n = self.u64()
        assert n == 32, f"expected 32-byte digest, got {n}"
        return self.raw(32)

    def vec(self, read_item) -> list:
        n = self.u64()
        return [read_item(self) for _ in range(n)]

    def field_vec(self, field_cls) -> list:
        return self.vec(lambda r: r.field(field_cls))

    def digest_vec(self) -> list:
        return self.vec(lambda r: r.digest())


    def option(self, read_item):
        return read_item(self) if self.boolean() else None
