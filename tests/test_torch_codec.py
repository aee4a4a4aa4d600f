"""Movement-plane codecs of the PyTorch port (``core/codec.py``).

The port's copy of the codec-only cases of ``tests/test_compression.py``:
codec frames (zlib / zrle / downcast), the compressibility probe and
payload-aware codec choice, and the numpy quantization kernels that
weight shipping (``serve.llm.pack_weights``) rests on. The wire and
spill cases, which need two live stores, are not copied here.
"""

import os
import struct

import numpy as np
import pytest

from ray_memory_management_tpu_torch.config import Config
from ray_memory_management_tpu_torch.core import codec
from _port_fixtures import one_intra_op_thread  # noqa: F401


def _text(n: int) -> bytes:
    para = (b"the quick brown fox jumps over the lazy dog; "
            b"pack my box with five dozen liquor jugs. ")
    return (para * (n // len(para) + 1))[:n]


def _sparse(n: int) -> bytes:
    """Float-gradient-shaped payload dominated by whole zero pages."""
    rng = np.random.default_rng(3)
    arr = rng.standard_normal(n // 4).astype(np.float32)
    raw = np.frombuffer(arr.tobytes(), np.uint8).copy()
    pages = raw[:len(raw) // 4096 * 4096].reshape(-1, 4096)
    pages[rng.random(len(pages)) < 0.875] = 0
    return raw.tobytes()


# --- codec unit layer --------------------------------------------------------

@pytest.mark.parametrize("name", codec.available_codecs())
def test_codec_roundtrip_byte_exact(name):
    for payload in (b"", b"x", _text(100_000), bytes(70_000),
                    _sparse(1 << 20), os.urandom(50_000)):
        assert codec.decode(codec.encode(payload, name), name) == payload


@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 3 * 4096,
                               3 * 4096 + 17])
def test_zrle_roundtrip_every_tail_shape(n):
    """Block boundaries and partial tails: all-zero, all-nonzero, and a
    mixed payload must all survive the bitmap framing."""
    for payload in (bytes(n), b"\x5a" * n,
                    (bytes(4096) + b"\x5a" * 4096) * (n // 8192 + 1)):
        payload = payload[:n]
        assert codec.decode(codec.encode(payload, codec.ZRLE),
                            codec.ZRLE) == payload


def test_zrle_decode_into_matches_decode():
    for payload in (bytes(20_000), _sparse(1 << 20),
                    _text(4096 * 3 + 100)):
        frame = codec.encode_frame(payload, codec.ZRLE)
        out = bytearray(len(payload) + 64)  # poison to prove the memset
        for i in range(len(out)):
            out[i] = 0xEE
        n = codec.decode_frame_into(frame, codec.ZRLE, memoryview(out))
        assert n == len(payload)
        assert bytes(out[:n]) == payload


def test_zrle_corrupt_frames_raise_codec_error():
    good = codec.encode(_sparse(64 << 10), codec.ZRLE)
    with pytest.raises(codec.CodecError):
        codec.decode(good[:2], codec.ZRLE)  # shorter than the header
    with pytest.raises(codec.CodecError):
        codec.decode(good[:-7], codec.ZRLE)  # truncated body
    # bitmap claims more non-zero blocks than the body carries
    (n,) = struct.unpack_from(">I", good)
    bad = bytearray(good)
    bad[4] |= 0xFF
    with pytest.raises(codec.CodecError):
        codec.decode(bytes(bad), codec.ZRLE)
    assert struct.unpack_from(">I", bad)[0] == n  # header untouched


def test_frame_crc_catches_flip_before_decode():
    """A flipped byte inside the COMPRESSED payload must fail the frame
    CRC (pre-decode); with verification off the poison reaches the
    decoder, which must raise CodecError — never return wrong bytes."""
    payload = _text(256 << 10)
    frame = bytearray(codec.encode_frame(payload, codec.ZLIB))
    frame[4] ^= 0xFF  # first compressed byte = the zlib CMF header
    with pytest.raises(codec.FrameIntegrityError):
        codec.decode_frame(bytes(frame), codec.ZLIB)
    with pytest.raises(codec.CodecError):
        codec.decode_frame(bytes(frame), codec.ZLIB, verify_crc=False)


def test_decode_frame_into_overflow_is_codec_error():
    payload = _text(128 << 10)
    for name in (codec.ZLIB, codec.ZRLE):
        frame = codec.encode_frame(payload, name)
        small = memoryview(bytearray(len(payload) - 1))
        with pytest.raises(codec.CodecError):
            codec.decode_frame_into(frame, name, small)


def test_downcast_roundtrip_tolerance():
    """The opt-in lossy downcast: f32 -> bf16 halves the bytes and the
    round trip stays within bf16's half-ULP relative error."""
    arr = np.random.default_rng(11).standard_normal(65_536).astype(
        np.float32)
    wire = codec.downcast_f32_bytes(arr.tobytes())
    assert len(wire) == arr.nbytes // 2
    back = np.frombuffer(codec.upcast_bf16_bytes(wire), np.float32)
    rel = np.abs(back - arr) / np.maximum(np.abs(arr), 1e-30)
    assert float(rel.max()) <= 2.0 ** -8
    # and via the generic encode/decode entry points (wire-codec shape)
    assert codec.decode(codec.encode(arr.tobytes(), codec.DOWNCAST_BF16),
                        codec.DOWNCAST_BF16) == back.tobytes()


def test_quantize_kernels_accuracy_envelope():
    rng = np.random.default_rng(5)
    arr = rng.standard_normal(10_000).astype(np.float32) * 8.0
    absmax = float(np.abs(arr).max())
    f32 = codec.quantize_array(arr, "f32")
    assert np.array_equal(codec.dequantize_array(f32), arr)  # bit-exact
    assert codec.quantized_nbytes(f32) == arr.nbytes
    bf16 = codec.quantize_array(arr, "bf16")
    err = np.abs(codec.dequantize_array(bf16) - arr).max() / absmax
    assert codec.quantized_nbytes(bf16) == arr.nbytes // 2
    assert err <= 2.0 ** -8
    i8 = codec.quantize_array(arr, "int8")
    err8 = np.abs(codec.dequantize_array(i8) - arr).max() / absmax
    assert codec.quantized_nbytes(i8) < arr.nbytes // 3
    assert err8 <= 1.5 / 127.0
    # zeros quantize to exact zeros at every precision
    z = np.zeros(1000, np.float32)
    for p in codec.PRECISIONS:
        assert not codec.dequantize_array(
            codec.quantize_array(z, p)).any()
    with pytest.raises(ValueError):
        codec.quantize_array(arr, "fp4")


# --- negotiation + probe -----------------------------------------------------

def test_negotiate_is_client_preference_order():
    assert codec.negotiate(None, codec.available_codecs()) is None
    assert codec.negotiate((), codec.available_codecs()) is None
    assert codec.negotiate(("nope", codec.ZLIB),
                           codec.available_codecs()) == codec.ZLIB
    assert codec.negotiate((codec.IDENTITY,), (codec.IDENTITY,)) is None
    assert codec.negotiate((codec.ZRLE, codec.ZLIB),
                           (codec.ZLIB, codec.ZRLE)) == codec.ZRLE


def test_client_codecs_from_config():
    assert codec.client_codecs(Config(transfer_compression="off")) is None
    assert codec.client_codecs(
        Config(transfer_compression="auto")) == codec.available_codecs()
    assert codec.client_codecs(
        Config(transfer_compression="zlib")) == (codec.ZLIB,)
    if codec.LZ4 not in codec.available_codecs():
        # the wheel is absent in this image: asking for it degrades to
        # no compression instead of a poison negotiation
        assert codec.client_codecs(
            Config(transfer_compression="lz4")) is None


def test_choose_codec_routes_by_payload():
    sup = codec.available_codecs()
    assert codec.choose_codec(None, sup, b"x" * 4096) == (None, "no_codec")
    assert codec.choose_codec((codec.IDENTITY,), sup,
                              b"x" * 4096) == (None, "no_codec")
    assert codec.choose_codec(sup, sup, b"") == (None, "below_threshold")
    # mostly-zero samples promote zrle over the ratio-winning deflate
    assert codec.choose_codec(sup, sup, _sparse(4 << 20))[0] == codec.ZRLE
    assert codec.choose_codec(sup, sup, bytes(1 << 20))[0] == codec.ZRLE
    # compressible non-zero text goes to the first general-purpose codec
    got, skip = codec.choose_codec(sup, sup, _text(1 << 20))
    assert skip is None and got in (codec.ZLIB, codec.LZ4)
    # high-entropy payloads skip encoding entirely
    assert codec.choose_codec(sup, sup, os.urandom(1 << 20)) == (
        None, "incompressible")
    # zrle-only common ground on a non-sparse payload saves nothing
    assert codec.choose_codec((codec.ZRLE,), sup, _text(1 << 20)) == (
        None, "incompressible")


def test_probe_compressible():
    assert codec.probe_compressible(_text(4 << 20))
    assert not codec.probe_compressible(os.urandom(4 << 20))
    assert not codec.probe_compressible(b"")


# --- wire layer: negotiated pulls -------------------------------------------
