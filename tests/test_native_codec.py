"""Native (C++) codec vs numpy reference implementations."""

import numpy as np
import pytest

from eventql_tpu.columnar import native


pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable"
)


def _np_simdbp128_unpack(buf, n, maxbits):
    # the pure-numpy reference (duplicated from cstable.simdbp128_unpack
    # body so the test doesn't recurse through the native fast path)
    if maxbits == 0:
        return np.zeros(n, dtype=np.uint32)
    nblocks = (n + 127) // 128
    words = np.frombuffer(buf, dtype="<u4", count=4 * maxbits * nblocks)
    W = words.reshape(nblocks, maxbits, 4)
    Wb = W.transpose(0, 2, 1).copy()
    bytes_view = Wb.view(np.uint8).reshape(nblocks, 4, maxbits * 4)
    bits = np.unpackbits(bytes_view, axis=2, bitorder="little")
    bits = bits.reshape(nblocks, 4, 32, maxbits)
    weights = 1 << np.arange(maxbits, dtype=np.uint64)
    vals = (bits.astype(np.uint64) * weights).sum(axis=3)
    out = vals.transpose(0, 2, 1).reshape(-1)
    return out[:n].astype(np.uint32)


def _pack_simdbp128(values, maxbits):
    """Inverse of the unpack layout, for test vector generation."""
    n = len(values)
    nblocks = (n + 127) // 128
    padded = np.zeros(nblocks * 128, dtype=np.uint64)
    padded[:n] = values
    out_words = np.zeros((nblocks, maxbits, 4), dtype=np.uint64)
    for blk in range(nblocks):
        for lane in range(4):
            stream = 0
            for k in range(32):
                v = int(padded[blk * 128 + 4 * k + lane])
                stream |= v << (k * maxbits)
            for w in range(maxbits):
                out_words[blk, w, lane] = (stream >> (32 * w)) & 0xFFFFFFFF
    return out_words.astype("<u4").tobytes()


@pytest.mark.parametrize("maxbits", [1, 2, 3, 5, 7, 8, 13, 17, 31, 32])
def test_simdbp128_roundtrip(maxbits):
    rng = np.random.default_rng(maxbits)
    n = 300
    maxv = (1 << maxbits) - 1
    vals = rng.integers(0, maxv + 1 if maxbits < 32 else 2**32, n).astype(
        np.uint64
    ) & np.uint64(maxv if maxbits < 32 else 0xFFFFFFFF)
    buf = _pack_simdbp128(vals, maxbits)
    got_native = native.simdbp128_unpack(buf, n, maxbits)
    got_np = _np_simdbp128_unpack(buf, n, maxbits)
    assert (got_native == vals.astype(np.uint32)).all()
    assert (got_np == vals.astype(np.uint32)).all()


def test_leb128():
    rng = np.random.default_rng(0)
    vals = np.concatenate(
        [
            rng.integers(0, 2**7, 100),
            rng.integers(0, 2**21, 100),
            rng.integers(0, 2**63, 100),
        ]
    ).astype(np.uint64)
    buf = bytearray()
    for v in vals:
        v = int(v)
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                buf.append(b | 0x80)
            else:
                buf.append(b)
                break
    out = native.leb128_decode(bytes(buf), len(vals))
    assert (out == vals).all()


def test_lenenc_strings():
    import struct

    strings = [b"", b"hello", b"x" * 300, "ünïcode".encode()]
    buf = b"".join(struct.pack("<I", len(s)) + s for s in strings)
    offsets, lengths = native.lenenc_strings(buf, len(strings))
    got = [buf[o : o + l] for o, l in zip(offsets, lengths)]
    assert got == strings


def test_cstable_reads_identically_with_and_without_native(monkeypatch, reference_dir):
    from tests.conftest import reference_path
    from eventql_tpu.columnar.cstable import CSTableReader

    path = reference_path("test", "sql_testdata", "testtbl.cst")
    with_native = CSTableReader(path).flat_column("time")

    monkeypatch.setenv("EVENTQL_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", False)
    without_native = CSTableReader(path).flat_column("time")
    monkeypatch.setattr(native, "_load_failed", False)

    assert (with_native.data == without_native.data).all()
    assert (with_native.valid == without_native.valid).all()


def test_leb128_encode_native_matches_python():
    """C encoder vs the Python reference encoder, bit-for-bit, across
    the value-width spectrum incl. the 10-byte 2^63+ tail."""
    from eventql_tpu.columnar import native

    rng = np.random.default_rng(11)
    vals = np.concatenate([
        rng.integers(0, 128, 500, dtype=np.uint64),
        rng.integers(0, 1 << 14, 500, dtype=np.uint64),
        rng.integers(0, 1 << 32, 500, dtype=np.uint64),
        rng.integers(0, 1 << 63, 500, dtype=np.uint64),
        np.array([0, 127, 128, (1 << 64) - 1], dtype=np.uint64),
    ])
    got = native.leb128_encode(vals)
    if got is None:
        import pytest
        pytest.skip("native lib unavailable")

    out = bytearray()
    for v in vals:
        v = int(v)
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                out.append(b | 0x80)
            else:
                out.append(b)
                break
    assert got == bytes(out)
    # and the decoder round-trips it
    dec = np.zeros(len(vals), dtype=np.uint64)
    import ctypes
    lib = native._try_load()
    consumed = lib.evql_leb128_decode(
        got, len(got), len(vals),
        dec.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    assert consumed == len(got)
    assert np.array_equal(dec, vals)
