"""The port's C entry points and the bf16 and fp16 flash kernels' variant
choice, checked without a card.

The kernels are bound through ctypes (paddle_tpu_torch/ops/_build.py):
every `extern "C"` entry point in paddle_tpu_torch/csrc/*.cu needs a
SIGNATURES entry of the same arity, with a pointer type exactly where the C
function takes a pointer (a pointer passed as a C int is cut to 32 bits,
which only a card would show). At bf16 and fp16 the forward, dq and dk/dv
entry points take their wgmma kernels (csrc/flash_attention_wgmma.cu) for
d <= 128 and their mma.sync kernels above; `kernel_variant` names the one
a launch takes, and the launch counts record it.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as fa

CSRC = Path(_build.__file__).resolve().parent.parent / "csrc"
_C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
            "float": ctypes.c_float}


def _entry_points():
    """{name: [ctypes type of each parameter]} of every extern "C" entry
    point in csrc/*.cu, from its declaration."""
    found = {}
    for path in sorted(CSRC.glob("*.cu")):
        text = path.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            types = []
            for param in m.group(2).split(","):
                words = param.replace("*", " * ").split()
                kind = "void*" if "*" in words else words[-2]
                assert kind in _C_TYPES, (m.group(1), param)
                types.append(_C_TYPES[kind])
            assert m.group(1) not in found, m.group(1)
            found[m.group(1)] = types
    return found


def test_every_entry_point_has_a_signature():
    assert set(_entry_points()) == set(_build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signature_matches_the_c_declaration(name):
    """Same arity, and ctypes.c_void_p exactly at the C pointers."""
    declared = _entry_points()[name]
    assert _build.SIGNATURES[name] == declared, (name, declared)


def test_every_source_is_built():
    assert sorted(_build.SOURCES) == sorted(p.name for p in CSRC.glob("*.cu"))


@pytest.mark.parametrize("d", [8, 40, 64, 96, 120, 128, 136, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("name", ["flash_forward", "flash_backward_dq",
                                  "flash_backward_dkv"])
def test_kernel_variant_by_dtype_and_head_dim(name, dtype, d):
    want = "wgmma" if dtype != torch.float32 and d <= 128 else "mma"
    assert fa.kernel_variant(name, dtype, d) == want


def test_kernel_variant_refuses_other_names():
    with pytest.raises(ValueError, match="flash_backward"):
        fa.kernel_variant("flash_backward", torch.bfloat16, 64)


@pytest.mark.parametrize("entry,launcher", [
    ("flash_attention_fwd_bf16", "launch_fwd_bf16_wgmma"),
    ("flash_attention_bwd_dq_bf16", "launch_dq_bf16_wgmma"),
    ("flash_attention_bwd_dkv_bf16", "launch_dkv_bf16_wgmma"),
    ("flash_attention_fwd_f16", "launch_fwd_f16_wgmma"),
    ("flash_attention_bwd_dq_f16", "launch_dq_f16_wgmma"),
    ("flash_attention_bwd_dkv_f16", "launch_dkv_f16_wgmma")])
def test_entry_points_take_wgmma_up_to_the_wrappers_head_dim(entry,
                                                             launcher):
    """The bf16 and fp16 entry points in flash_attention.cu call their
    kernel's helper (fwd_entry16 and the like) with their element type,
    and the helper dispatches that type to the wgmma kernels at the head
    dim `kernel_variant` names, and every other case to the mma.sync
    kernel of d = 256."""
    text = (CSRC / "flash_attention.cu").read_text()
    body = text[text.index(f'extern "C" int {entry}('):]
    body = body[:body.index("\n}\n")]
    kind = "kF16" if entry.endswith("_f16") else "kBf16"
    helper = re.search(r"return (\w+)<(\w+)>\(", body)
    assert helper is not None and helper.group(2) == kind, body
    text = text[text.index(f"int {helper.group(1)}("):]
    text = text[:text.index("\n}\n")]
    m = re.search(r"if \(dm\.d <= (\d+)\) \{\s*return \(int\)\(H == kF16\s*"
                  r"\? flash::(\w+)\([^:]*: flash::(\w+)\(", text)
    assert m is not None, text
    chosen = m.group(2) if kind == "kF16" else m.group(3)
    assert (int(m.group(1)), chosen) == (fa.WGMMA_MAX_HEAD_DIM, launcher)
    assert "<256, H>" in text[m.end():]


def test_cpu_launches_count_no_kernel_variant():
    """On CPU tensors the wrappers run the plain versions and count no
    kernel variant."""
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, 16, 2, 64))
                                    .astype(np.float32)).to(torch.bfloat16)
                   for _ in range(4))
    fa.reset_counts()
    o, lse = fa.flash_forward(q, k, v, True)
    fa.flash_backward(q, k, v, o, do, lse, True)
    for c in fa.counts_for(False, torch.bfloat16).values():
        assert (c.kernel_launches, c.plain_launches, c.form_launches) == \
            (0, 1, {})
