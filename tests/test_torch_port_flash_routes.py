"""PyTorch port: which flash kernel a wrapper launches, checked without a card.

``ops/flash_attention.route`` decides from the head dim, the dtype and the
role (forward, dQ, dK/dV) which kernel a wrapper launches on CUDA tensors,
and which CUDA source's library exports it. bf16 goes to the tensor-core
kernels (``csrc/flash_attention_sm90.cu``: every role at head_dim 64 and
128 and the head_dim-512 forward, on wgmma), fp16 to the same templates
built for fp16 (every role at 64 and 128; float16 at head_dim 512 is not
ported and raises), fp32 to the fp32 kernels
(``csrc/flash_attention_fp32.cu``: every role at 64 and 128 and the
forward at 512, all in 3xTF32 on mma.sync), so that no fp32 operand is
rounded to bf16. The backward at head_dim 512 has no kernel in either
dtype. Each entry point is checked to be defined in its source, and each
source to define no other; no WMMA source remains, and every kernel of
the fp32 source runs its products on the tensor cores.
"""

import re

import pytest
import torch

from aozora_sdxl_training_tpu_torch.ops import cuda_build
from aozora_sdxl_training_tpu_torch.ops import flash_attention as port

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
SM90, FP32 = "flash_attention_sm90", "flash_attention_fp32"
ROUTE_TABLE = {
    (64, BF16): (("flash_fwd", SM90), ("flash_bwd_dq", SM90), ("flash_bwd_dkv", SM90)),
    (128, BF16): (("flash_fwd_d128", SM90), ("flash_bwd_dq_d128", SM90),
                  ("flash_bwd_dkv_d128", SM90)),
    (512, BF16): (("flash_fwd_d512", SM90), None, None),
    (64, F16): (("flash_fwd_f16", SM90), ("flash_bwd_dq_f16", SM90), ("flash_bwd_dkv_f16", SM90)),
    (128, F16): (("flash_fwd_f16_d128", SM90), ("flash_bwd_dq_f16_d128", SM90),
                 ("flash_bwd_dkv_f16_d128", SM90)),
    (64, F32): (("flash_fwd_f32_d64", FP32), ("flash_bwd_dq_f32_d64", FP32),
                ("flash_bwd_dkv_f32_d64", FP32)),
    (128, F32): (("flash_fwd_f32_d128", FP32), ("flash_bwd_dq_f32_d128", FP32),
                 ("flash_bwd_dkv_f32_d128", FP32)),
    (512, F32): (("flash_fwd_f32_d512", FP32), None, None),
}


@pytest.mark.parametrize("role", ["forward", "dq", "dkv"])
@pytest.mark.parametrize("dtype", [BF16, F16, F32], ids=["bf16", "fp16", "fp32"])
@pytest.mark.parametrize("head_dim", [64, 128, 512])
def test_route_by_head_dim_dtype_and_role(head_dim, dtype, role):
    if (head_dim, dtype) not in ROUTE_TABLE:       # float16 at head_dim 512
        with pytest.raises(TypeError, match="float16 at head_dim 512 is not ported"):
            port.route(head_dim, dtype, role)
        return
    want = ROUTE_TABLE[head_dim, dtype][("forward", "dq", "dkv").index(role)]
    if want is None:
        with pytest.raises(NotImplementedError, match="head_dim 512"):
            port.route(head_dim, dtype, role)
    else:
        assert port.route(head_dim, dtype, role) == want
        assert want[0] in port.LAUNCHES


def test_other_head_dims_and_dtypes_have_no_kernel():
    with pytest.raises(ValueError, match="head_dim 96"):
        port.route(96, BF16, "forward")
    with pytest.raises(TypeError, match="bfloat16, float16 or float32"):
        port.route(64, torch.float64, "forward")
    with pytest.raises(TypeError, match="float16 at head_dim 512 is not ported"):
        port.route(512, F16, "forward")
    assert set(port.LAUNCHES) == {name for row in ROUTE_TABLE.values()
                                  for entry in row if entry for name in entry[:1]}


def test_every_entry_point_is_defined_in_its_source():
    """Each kernel's C entry point ``aozora_<name>`` is defined in the
    source ``route`` names, and each source defines no other kernel entry
    point (each also exports its attribute query); the two sources are
    every flash source of ``csrc/``."""
    assert set(port.SOURCES.values()) == {SM90, FP32}
    assert sorted(p.stem for p in cuda_build.CSRC.glob("flash_*.cu")) == [FP32, SM90]
    for source in (SM90, FP32):
        text = (cuda_build.CSRC / f"{source}.cu").read_text()
        defined = set(re.findall(r"^int aozora_(\w+)\(", text, re.M)) - {
            "flash_sm90_attributes", "flash_fp32_attributes"}
        assert defined == {n for n, src in port.SOURCES.items() if src == source}, source
        assert "aozora_flash_error_string" in text


def test_the_head_dim_64_forward_is_the_wgmma_kernel():
    """No WMMA source remains: K1 is flash_fwd_sm90_kernel at head_dim 64
    and the bf16 head_dim-512 forward is flash_fwd_d512_sm90_kernel, both
    exported by the sm90 source, and no source uses the WMMA API."""
    assert not (cuda_build.CSRC / "flash_attention.cu").exists()
    for path in cuda_build.CSRC.glob("*.cu*"):
        assert "nvcuda::wmma" not in path.read_text() and "<mma.h>" not in path.read_text(), path
    sm90 = (cuda_build.CSRC / f"{SM90}.cu").read_text()
    assert re.search(r"^int aozora_flash_fwd\([^)]*\)\s*\{\s*return fwd<bf16, 64>", sm90, re.M)
    assert re.search(r"^int aozora_flash_fwd_d512\([^)]*\)\s*\{\s*return fwd_d512\(", sm90,
                     re.M)
    assert re.search(r"^flash_fwd_d512_sm90_kernel\(", sm90, re.M)


@pytest.mark.parametrize("dtype", [BF16, F16], ids=["bf16", "fp16"])
def test_each_16_bit_entry_point_launches_the_wgmma_template_of_its_dtype(dtype):
    """Each bf16 and fp16 entry point at head_dim 64 and 128 calls the
    launcher of its role with the element type of its route (bf16 or f16)
    and its head dim: the same template kernel, built for both types; no
    entry point converts fp16 to bf16."""
    sm90 = (cuda_build.CSRC / f"{SM90}.cu").read_text()
    elem = {BF16: "bf16", F16: "f16"}[dtype]
    for d in (64, 128):
        for (name, _), launcher in zip(ROUTE_TABLE[d, dtype], ("fwd", "bwd_dq", "bwd_dkv")):
            assert re.search(rf"^int aozora_{name}\([^)]*\)\s*\{{\s*return "
                             rf"{launcher}<{elem}, {d}>\(", sm90, re.M), name
    assert "__float2bfloat16" not in sm90 and "__half2float" not in sm90
    header = (cuda_build.CSRC / "sm90_wgmma.cuh").read_text()
    assert 'AOZORA_MMA_SS("f16")' in header and 'AOZORA_MMA_RS128("f16")' in header


def _functions(text):
    """{name: body} of every function defined in a CUDA source: its name is
    the identifier before the parameter list, its body the braces after."""
    found = {}
    for m in re.finditer(r"(?:__global__|__device__)[^;{(]*?(?:__launch_bounds__\([^)]*\)\s*)?"
                         r"(\w+)\s*\(", text):
        depth, i = 1, m.end()
        while depth:                         # the parameter list
            depth += {"(": 1, ")": -1}.get(text[i], 0)
            i += 1
        if text[i:].lstrip()[:1] != "{":
            continue
        start = text.index("{", i)
        depth, i = 1, start + 1
        while depth:
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            i += 1
        found[m.group(1)] = text[start:i]
    return found


def test_every_fp32_kernel_runs_on_the_tensor_cores():
    """Each __global__ kernel of the fp32 source reaches mma_3xtf32 (directly
    or through the helpers it calls), and the CUDA-core design's helpers are
    gone."""
    text = (cuda_build.CSRC / f"{FP32}.cu").read_text()
    functions = _functions(text)
    kernels = set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(",
                             text))
    assert kernels == {"flash_fwd_3xtf32_kernel", "flash_bwd_dq_3xtf32_kernel",
                       "flash_bwd_dkv_3xtf32_kernel", "flash_fwd_f32_d512_kernel"}
    reaches = {"mma_3xtf32"}
    while True:
        more = {name for name, body in functions.items()
                if any(re.search(rf"\b{callee}\s*(?:<[^;{{}}]*?>)?\s*\(", body)
                       for callee in reaches)} - reaches
        if not more:
            break
        reaches |= more
    assert kernels <= reaches, kernels - reaches
    for gone in ("nt_product", "nn_accumulate", "lane4", "store_tile", "Cfg"):
        assert not re.search(rf"\b{gone}\b", text), gone
