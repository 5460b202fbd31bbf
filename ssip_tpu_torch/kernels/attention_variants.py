"""Time variants of ``csrc/attention_unpacked_mma.cu`` (the unpacked bf16
attention pair) or, with ``--f32``, of ``csrc/attention_f32_mma.cu`` (the
float32 forward of both pairs) against each other on one card: what
PERF.md's design notes for those kernels rest on.

Each variant is a copy of the source with some of its lines replaced (a
constant, a helper's body, or the test that sends full tiles down their
branch-free path), built by nvcc into ``build/ssip_tpu_torch/variants/``
with a C entry of its own, and checked against the plain versions (bf16:
one bf16 step, output and gradients; float32: the output within 2e-5)
before it is timed. Every variant then runs at each shape in turns (first
to last, last to first) and the smaller of its two medians of CUDA-event
times is printed, with ``scaled_dot_product_attention``'s beside.

    python -m ssip_tpu_torch.kernels.attention_variants          # one CUDA card
    python -m ssip_tpu_torch.kernels.attention_variants --f32
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ssip_tpu_torch.kernels.build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, find_nvcc
from ssip_tpu_torch.ops.attention import _scale, attention_bwd_plain, attention_unrounded_plain

SOURCE = CSRC_DIR / "attention_unpacked_mma.cu"
VARIANTS = {
    "kernel": [],
    "every tile guarded": [("if (valid == kTile) {", "if (false) {")],
    "3 stages": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    "8 warps a block": [("constexpr int kWarps = 4;", "constexpr int kWarps = 8;"),
                        ("constexpr int kFwdBlocksPerSm = 4;", "constexpr int kFwdBlocksPerSm = 2;"),
                        ("constexpr int kBwdBlocksPerSm = 3;", "constexpr int kBwdBlocksPerSm = 1;")],
    "32-row tiles": [("constexpr int kTile = 64;", "constexpr int kTile = 32;")],
    "128-row tiles": [("constexpr int kTile = 64;", "constexpr int kTile = 128;"),
                      ("constexpr int kFwdBlocksPerSm = 4;", "constexpr int kFwdBlocksPerSm = 3;"),
                      ("constexpr int kBwdBlocksPerSm = 3;", "constexpr int kBwdBlocksPerSm = 2;")],
}
ENTRIES = r'''
extern "C" int variant_fwd(const void* q, const void* k, const void* v, void* o, int bh, int s, int dh,
                           float scale, void* stream) {
  return attention_fwd_bf16(q, k, v, o, bh, s, dh, scale, static_cast<cudaStream_t>(stream));
}
extern "C" int variant_bwd(const void* q, const void* k, const void* v, const void* d_o, void* dq, void* dk,
                           void* dv, void* stats, int bh, int s, int dh, float scale, void* stream) {
  return attention_bwd_bf16(q, k, v, d_o, dq, dk, dv, stats, bh, s, dh, scale, static_cast<cudaStream_t>(stream));
}
'''
# (batch, heads, tokens, head width): chip_smoke.py's bf16 [attn4] shapes
SHAPES = ((128, 12, 197, 64), (16, 12, 577, 64), (4, 12, 1024, 64), (2, 4, 1024, 32))
TIMED = 20

F32_SOURCE = CSRC_DIR / "attention_f32_mma.cu"
F32_VARIANTS = {
    "kernel": [],
    "cvt.rna split": [("  hi = __float_as_uint(x) & 0xffffe000u;\n  lo = __float_as_uint(x - __uint_as_float(hi));",
                       "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(hi) : \"f\"(x));\n"
                       "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(lo) : \"f\"(x - __uint_as_float(hi)));")],
    "every tile guarded": [("if (valid == kTile) {", "if (false) {")],
    "2 blocks an SM": [("constexpr int kBlocksPerSm = 3;", "constexpr int kBlocksPerSm = 2;")],
    "3 stages": [("constexpr int kStages = 2;", "constexpr int kStages = 3;"),
                 ("constexpr int kBlocksPerSm = 3;", "constexpr int kBlocksPerSm = 2;")],
}
F32_ENTRIES = r'''
extern "C" int variant_fwd(const void* q, const void* k, const void* v, void* o, int bh, int s, int dh,
                           float scale, void* stream) {
  return attention_fwd_f32(q, k, v, o, bh, s, dh, scale, static_cast<cudaStream_t>(stream));
}
'''
# (batch, heads, tokens, head width): chip_smoke.py's float32 [attn4] shapes
F32_SHAPES = ((128, 12, 197, 64), (128, 12, 256, 64), (8, 2, 50, 32))


def build_variants(source=SOURCE, variants=VARIANTS, entries_src=ENTRIES) -> dict:
    """name -> (forward, backward or None) C entries, built in parallel."""
    out_dir = BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = source.read_text()
    procs = {}
    for i, (name, subs) in enumerate(variants.items()):
        src = text
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"variant {name!r}: {old!r} is not in {source.name}")
            src = src.replace(old, new)
        cu = out_dir / f"{source.stem}_variant{i}.cu"
        cu.write_text(src + entries_src)
        lib = out_dir / f"{source.stem}_variant{i}.so"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-shared", "-o", str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    entries = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{log}")
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"[variants] variant={name.replace(' ', '_')} ptxas: {line.strip()}")
        handle = ctypes.CDLL(str(lib))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        handle.variant_fwd.argtypes = [p, p, p, p, i, i, i, f, p]
        bwd = getattr(handle, "variant_bwd", None)
        if bwd is not None:
            bwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, f, p]
        entries[name] = (handle.variant_fwd, bwd)
    return entries


def calls(entry, q, k, v, d_o):
    """The variant's forward and backward on these operands, as closures."""
    b, h, s, dh = q.shape
    o, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
    stats = torch.empty(b * h * 3 * (-(-s // 16) * 16), device=q.device)
    stream = torch.cuda.current_stream().cuda_stream

    def fwd():
        if entry[0](q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b * h, s, dh, _scale(dh), stream):
            raise RuntimeError("variant forward launch failed")

    def bwd():
        if entry[1](q.data_ptr(), k.data_ptr(), v.data_ptr(), d_o.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), stats.data_ptr(), b * h, s, dh, _scale(dh), stream):
            raise RuntimeError("variant backward launch failed")

    return fwd, bwd, (o, dq, dk, dv)


def within_one_step(got: torch.Tensor, ref: torch.Tensor) -> bool:
    err = (got.float() - ref.float()).abs()
    step = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp_min(1e-30))) - 7)
    return bool((err <= torch.maximum(step, torch.full_like(step, 2e-5))).all())


def median_ms(fn) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMED):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[TIMED // 2]


def main_f32() -> None:
    """The float32 forward's variants: each within 2e-5 of the plain version
    at [4, 12, 197, 64], then timed at ``F32_SHAPES`` beside SDPA."""
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in true float32
    entries = build_variants(F32_SOURCE, F32_VARIANTS, F32_ENTRIES)
    rng = np.random.default_rng(0)
    operands = [torch.from_numpy(rng.standard_normal((4, 12, 197, 64)).astype(np.float32)).cuda() for _ in range(4)]
    ref = attention_unrounded_plain(*operands[:3])
    for name, entry in entries.items():
        fwd, _, outs = calls(entry, *operands)
        fwd()
        torch.cuda.synchronize()
        err = (outs[0] - ref).abs().max().item()
        print(f"[variants] variant={name.replace(' ', '_')} max_abs_err={err:.3g}")
        if not err <= 2e-5:
            raise AssertionError(f"variant {name!r} is {err} off the plain version, allowed 2e-5")
    for shape in F32_SHAPES:
        q, k, v, d_o = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda() for _ in range(4))
        times = {name: [] for name in entries}
        for name in [*entries, *reversed(entries)]:
            times[name].append(median_ms(calls(entries[name], q, k, v, d_o)[0]))
        print(f"[variants] shape={'x'.join(map(str, shape))} variant=sdpa "
              f"fwd_ms={median_ms(lambda: F.scaled_dot_product_attention(q, k, v)):.4f}")
        for name, f_ms in times.items():
            print(f"[variants] shape={'x'.join(map(str, shape))} variant={name.replace(' ', '_')} "
                  f"fwd_ms={min(f_ms):.4f}", flush=True)


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in true float32
    entries = build_variants()
    rng = np.random.default_rng(0)
    operands = [torch.from_numpy(rng.standard_normal((4, 12, 197, 64)).astype(np.float32)).cuda().bfloat16()
                for _ in range(4)]
    refs = (attention_unrounded_plain(*operands[:3]), *attention_bwd_plain(*operands))
    for name, entry in entries.items():
        fwd, bwd, outs = calls(entry, *operands)
        fwd()
        bwd()
        torch.cuda.synchronize()
        if not all(within_one_step(got, ref) for got, ref in zip(outs, refs)):
            raise AssertionError(f"variant {name!r} is not within one bf16 step of the plain versions")
    for shape in SHAPES:
        q, k, v, d_o = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda().bfloat16()
                        for _ in range(4))
        times = {name: ([], []) for name in entries}
        for name in [*entries, *reversed(entries)]:
            fwd, bwd, _ = calls(entries[name], q, k, v, d_o)
            times[name][0].append(median_ms(fwd))
            times[name][1].append(median_ms(bwd))
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        o_lib = F.scaled_dot_product_attention(*leaves)
        print(f"[variants] shape={'x'.join(map(str, shape))} variant=sdpa "
              f"fwd_ms={median_ms(lambda: F.scaled_dot_product_attention(q, k, v)):.4f} "
              f"bwd_ms={median_ms(lambda: torch.autograd.grad(o_lib, leaves, d_o, retain_graph=True)):.4f}")
        for name, (f_ms, b_ms) in times.items():
            print(f"[variants] shape={'x'.join(map(str, shape))} variant={name.replace(' ', '_')} "
                  f"fwd_ms={min(f_ms):.4f} bwd_ms={min(b_ms):.4f}", flush=True)


if __name__ == "__main__":
    main_f32() if "--f32" in sys.argv[1:] else main()
