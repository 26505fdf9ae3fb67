"""GGUF export: Q8_0 / Q5_0 / Q4_0 block quantization + GGUF v3 container.

The reference converter ships an experimental GGUF path
(reference scripts/convert_anima_to_quants.py:3414-3450).  This module
implements the public ggml block formats from their specification:

* Q8_0: 32-element blocks, fp16 scale ``d = absmax/127`` + 32x int8;
* Q4_0: 32-element blocks, fp16 ``d = absmax/-8``, codes ``round(x/d)+8``
  packed as nibbles (low nibble = elem j, high nibble = elem j+16);
* Q5_0: fp16 ``d = absmax/-16``, 5-bit codes: 4 low bits packed like Q4_0
  plus a uint32 of high bits.

And a minimal GGUF v3 writer/reader pair (magic, metadata KVs, tensor infos,
32-byte aligned data section) with exact dequantizers for round-trip tests.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

GGUF_MAGIC = b"GGUF"
GGUF_VERSION = 3
ALIGNMENT = 32

# ggml tensor type ids
GGML_F32 = 0
GGML_F16 = 1
GGML_Q4_0 = 2
GGML_Q5_0 = 6
GGML_Q8_0 = 8

QK = 32  # block size for the classic quant formats

# GGUF metadata value type ids
_KV_STR = 8
_KV_U32 = 4
_KV_F32 = 6


# --------------------------------------------------------------------------
# Block quantizers (per 32-element block)
# --------------------------------------------------------------------------

def _blocked(x: np.ndarray) -> np.ndarray:
    flat = np.asarray(x, np.float32).reshape(-1)
    if flat.size % QK:
        raise ValueError(f"tensor size {flat.size} not divisible by {QK}")
    return flat.reshape(-1, QK)


def quantize_q8_0(x: np.ndarray) -> bytes:
    blocks = _blocked(x)
    d = np.abs(blocks).max(axis=1) / 127.0
    d_safe = np.where(d == 0, 1.0, d)
    q = np.clip(np.round(blocks / d_safe[:, None]), -128, 127).astype(np.int8)
    out = bytearray()
    d16 = d.astype(np.float16)
    for i in range(blocks.shape[0]):
        out += d16[i].tobytes() + q[i].tobytes()
    return bytes(out)


def dequantize_q8_0(data: bytes, n: int) -> np.ndarray:
    nb = n // QK
    out = np.empty((nb, QK), np.float32)
    for i in range(nb):
        off = i * 34
        d = np.frombuffer(data, np.float16, 1, off)[0]
        q = np.frombuffer(data, np.int8, QK, off + 2)
        out[i] = q.astype(np.float32) * np.float32(d)
    return out.reshape(-1)


def quantize_q4_0(x: np.ndarray) -> bytes:
    blocks = _blocked(x)
    amax_idx = np.argmax(np.abs(blocks), axis=1)
    maxv = blocks[np.arange(blocks.shape[0]), amax_idx]  # signed extreme
    d = maxv / -8.0
    d_safe = np.where(d == 0, 1.0, d)
    q = np.clip(np.round(blocks / d_safe[:, None]) + 8, 0, 15).astype(np.uint8)
    out = bytearray()
    d16 = d.astype(np.float16)
    for i in range(blocks.shape[0]):
        lo, hi = q[i, :16], q[i, 16:]
        packed = (lo | (hi << 4)).astype(np.uint8)
        out += d16[i].tobytes() + packed.tobytes()
    return bytes(out)


def dequantize_q4_0(data: bytes, n: int) -> np.ndarray:
    nb = n // QK
    out = np.empty((nb, QK), np.float32)
    for i in range(nb):
        off = i * 18
        d = np.float32(np.frombuffer(data, np.float16, 1, off)[0])
        packed = np.frombuffer(data, np.uint8, 16, off + 2)
        lo = (packed & 0x0F).astype(np.int32) - 8
        hi = (packed >> 4).astype(np.int32) - 8
        out[i, :16] = lo * d
        out[i, 16:] = hi * d
    return out.reshape(-1)


def quantize_q5_0(x: np.ndarray) -> bytes:
    blocks = _blocked(x)
    amax_idx = np.argmax(np.abs(blocks), axis=1)
    maxv = blocks[np.arange(blocks.shape[0]), amax_idx]
    d = maxv / -16.0
    d_safe = np.where(d == 0, 1.0, d)
    q = np.clip(np.round(blocks / d_safe[:, None]) + 16, 0, 31).astype(np.uint8)
    out = bytearray()
    d16 = d.astype(np.float16)
    for i in range(blocks.shape[0]):
        qi = q[i]
        qh = 0
        for j in range(16):
            qh |= ((int(qi[j]) >> 4) & 1) << j
            qh |= ((int(qi[j + 16]) >> 4) & 1) << (j + 16)
        lo = qi[:16] & 0x0F
        hi = qi[16:] & 0x0F
        packed = (lo | (hi << 4)).astype(np.uint8)
        out += d16[i].tobytes() + struct.pack("<I", qh) + packed.tobytes()
    return bytes(out)


def dequantize_q5_0(data: bytes, n: int) -> np.ndarray:
    nb = n // QK
    out = np.empty((nb, QK), np.float32)
    for i in range(nb):
        off = i * 22
        d = np.float32(np.frombuffer(data, np.float16, 1, off)[0])
        (qh,) = struct.unpack_from("<I", data, off + 2)
        packed = np.frombuffer(data, np.uint8, 16, off + 6)
        for j in range(16):
            lo5 = (packed[j] & 0x0F) | (((qh >> j) & 1) << 4)
            hi5 = (packed[j] >> 4) | (((qh >> (j + 16)) & 1) << 4)
            out[i, j] = (int(lo5) - 16) * d
            out[i, j + 16] = (int(hi5) - 16) * d
    return out.reshape(-1)


_QUANTIZERS = {
    GGML_Q8_0: (quantize_q8_0, 34),
    GGML_Q5_0: (quantize_q5_0, 22),
    GGML_Q4_0: (quantize_q4_0, 18),
}
TYPE_BY_NAME = {"f32": GGML_F32, "f16": GGML_F16, "q8_0": GGML_Q8_0,
                "q5_0": GGML_Q5_0, "q4_0": GGML_Q4_0}


# --------------------------------------------------------------------------
# GGUF v3 container
# --------------------------------------------------------------------------

def _pack_str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return struct.pack("<Q", len(raw)) + raw


def _pack_kv(key: str, value) -> bytes:
    out = _pack_str(key)
    if isinstance(value, str):
        out += struct.pack("<I", _KV_STR) + _pack_str(value)
    elif isinstance(value, int):
        out += struct.pack("<I", _KV_U32) + struct.pack("<I", value)
    elif isinstance(value, float):
        out += struct.pack("<I", _KV_F32) + struct.pack("<f", value)
    else:
        raise TypeError(f"unsupported GGUF metadata value: {value!r}")
    return out


def write_gguf(path, tensors: dict[str, tuple[np.ndarray, str]],
               metadata: dict | None = None) -> None:
    """tensors: {name: (array, type_name)} with type in TYPE_BY_NAME.

    GGML dims are reversed relative to numpy (fastest-varying first).
    """
    metadata = dict(metadata or {})
    metadata.setdefault("general.architecture", "aozora")
    entries = []
    blobs = []
    offset = 0
    for name, (array, type_name) in tensors.items():
        array = np.asarray(array)
        ggml_type = TYPE_BY_NAME[type_name]
        if ggml_type == GGML_F32:
            blob = array.astype(np.float32).tobytes()
        elif ggml_type == GGML_F16:
            blob = array.astype(np.float16).tobytes()
        else:
            quantizer, _ = _QUANTIZERS[ggml_type]
            blob = quantizer(array)
        entries.append((name, array.shape, ggml_type, offset))
        blobs.append(blob)
        offset += len(blob)
        pad = (-offset) % ALIGNMENT
        offset += pad
        blobs.append(b"\x00" * pad)

    with open(path, "wb") as f:
        f.write(GGUF_MAGIC)
        f.write(struct.pack("<I", GGUF_VERSION))
        f.write(struct.pack("<Q", len(entries)))
        f.write(struct.pack("<Q", len(metadata)))
        for k, v in metadata.items():
            f.write(_pack_kv(k, v))
        for name, shape, ggml_type, off in entries:
            f.write(_pack_str(name))
            dims = list(reversed(shape))
            f.write(struct.pack("<I", len(dims)))
            for dim in dims:
                f.write(struct.pack("<Q", dim))
            f.write(struct.pack("<I", ggml_type))
            f.write(struct.pack("<Q", off))
        pos = f.tell()
        f.write(b"\x00" * ((-pos) % ALIGNMENT))
        for blob in blobs:
            f.write(blob)


def read_gguf(path) -> tuple[dict, dict]:
    """Returns ({name: np.ndarray (dequantized fp32)}, metadata)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != GGUF_MAGIC:
        raise ValueError("not a GGUF file")
    version, = struct.unpack_from("<I", data, 4)
    n_tensors, = struct.unpack_from("<Q", data, 8)
    n_kv, = struct.unpack_from("<Q", data, 16)
    pos = 24

    def read_str():
        nonlocal pos
        (n,) = struct.unpack_from("<Q", data, pos)
        pos += 8
        s = data[pos:pos + n].decode("utf-8")
        pos += n
        return s

    metadata = {}
    for _ in range(n_kv):
        key = read_str()
        (vtype,) = struct.unpack_from("<I", data, pos)
        pos += 4
        if vtype == _KV_STR:
            metadata[key] = read_str()
        elif vtype == _KV_U32:
            (metadata[key],) = struct.unpack_from("<I", data, pos)
            pos += 4
        elif vtype == _KV_F32:
            (metadata[key],) = struct.unpack_from("<f", data, pos)
            pos += 4
        else:
            raise ValueError(f"unsupported metadata type {vtype}")

    infos = []
    for _ in range(n_tensors):
        name = read_str()
        (nd,) = struct.unpack_from("<I", data, pos)
        pos += 4
        dims = struct.unpack_from(f"<{nd}Q", data, pos)
        pos += 8 * nd
        ggml_type, = struct.unpack_from("<I", data, pos)
        pos += 4
        off, = struct.unpack_from("<Q", data, pos)
        pos += 8
        infos.append((name, tuple(reversed(dims)), ggml_type, off))
    pos += (-pos) % ALIGNMENT
    base = pos

    tensors = {}
    for name, shape, ggml_type, off in infos:
        n = int(np.prod(shape))
        start = base + off
        if ggml_type == GGML_F32:
            arr = np.frombuffer(data, np.float32, n, start).reshape(shape)
        elif ggml_type == GGML_F16:
            arr = np.frombuffer(data, np.float16, n, start).astype(np.float32).reshape(shape)
        elif ggml_type == GGML_Q8_0:
            nbytes = (n // QK) * 34
            arr = dequantize_q8_0(data[start:start + nbytes], n).reshape(shape)
        elif ggml_type == GGML_Q5_0:
            nbytes = (n // QK) * 22
            arr = dequantize_q5_0(data[start:start + nbytes], n).reshape(shape)
        elif ggml_type == GGML_Q4_0:
            nbytes = (n // QK) * 18
            arr = dequantize_q4_0(data[start:start + nbytes], n).reshape(shape)
        else:
            raise ValueError(f"unsupported ggml type {ggml_type}")
        tensors[name] = arr
    return tensors, metadata


def export_checkpoint(input_path, output_path, *, quant: str = "q8_0",
                      keep_2d_only: bool = True) -> dict:
    """Quantize a safetensors checkpoint into a GGUF file."""
    from ..ckpt.safetensors_io import is_requantizable_dtype, load_all
    state = load_all(input_path)
    tensors: dict[str, tuple[np.ndarray, str]] = {}
    report = {"quantized": 0, "kept": 0}
    for name, arr in state.items():
        arr = np.asarray(arr)
        eligible = (is_requantizable_dtype(arr.dtype) and arr.size % QK == 0
                    and (arr.ndim >= 2 or not keep_2d_only))
        if eligible and arr.ndim >= 2:
            tensors[name] = (arr.astype(np.float32), quant)
            report["quantized"] += 1
        elif is_requantizable_dtype(arr.dtype):
            tensors[name] = (arr.astype(np.float32), "f16")
            report["kept"] += 1
        else:
            continue  # GGUF here carries float weights only
    write_gguf(Path(output_path), tensors,
               metadata={"general.name": Path(input_path).stem,
                         "aozora.quant": quant})
    return report


def main(argv=None) -> None:
    import argparse
    import json
    parser = argparse.ArgumentParser(description="Export a checkpoint to GGUF.")
    parser.add_argument("input")
    parser.add_argument("output")
    parser.add_argument("--quant", default="q8_0",
                        choices=["q8_0", "q5_0", "q4_0", "f16"])
    args = parser.parse_args(argv)
    print(json.dumps(export_checkpoint(args.input, args.output,
                                       quant=args.quant)))


if __name__ == "__main__":
    main()
