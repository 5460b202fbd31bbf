"""Time variants of ``csrc/attention_unpacked_mma.cu`` (the unpacked bf16
attention pair), with ``--f32`` of ``csrc/attention_f32_mma.cu`` (the
float32 forward and backward of both pairs) or, with ``--rounded``, of
``csrc/attention_mma.cu`` (the bf16 pair that rounds p, run on q, k, v as the
unpacked entry runs it past 1024 tokens) against each other on one card:
what PERF.md's design notes for those kernels rest on.

Each variant is a copy of the source with some of its lines replaced (a
constant, a helper's body, or the test that sends full tiles down their
branch-free path), built by nvcc into ``build/ssip_tpu_torch/variants/``
with a C entry of its own, and checked against the plain versions (bf16:
one bf16 step, output and gradients; float32: the output within 2e-5, the
gradients within 1e-5 of each tensor's largest entry) before it is timed.
Every variant then runs at each shape in turns (first to last, last to
first) and the smaller of its two medians of CUDA-event times is printed,
with ``scaled_dot_product_attention``'s beside (the float32 backward is
timed from the forward's output and row statistics, as autograd runs it).
With ``--rounded`` the packed entry is timed at its main shape too, beside
diagnostic copies of the whole-head forward with a phase cut out (printed
with ``diagnostic=1``: not checked, their output is not the function's), and
the kernel's device time there is printed, with the SM clock and power draw
``nvidia-smi`` reads while it runs back to back.

    python -m ssip_tpu_torch.kernels.attention_variants          # one CUDA card
    python -m ssip_tpu_torch.kernels.attention_variants --f32
    python -m ssip_tpu_torch.kernels.attention_variants --rounded
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ssip_tpu_torch.kernels.build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, find_nvcc
from ssip_tpu_torch.ops.attention import (
    _scale, attention_bwd_plain, attention_plain, attention_qkv_plain, attention_rounded_bwd_plain,
    attention_unrounded_plain,
)

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

ROUNDED_SOURCE = CSRC_DIR / "attention_mma.cu"
# the streamed forward's designs: scores cached in shared memory while they
# fit (the kernel), or always three sweeps over K; its tiles; the packed
# entry streamed at 197 tokens too, where it runs the whole-head kernel; and
# the whole-head kernel's warps a block and score-loop unrolling
_SCORE_LOOP = "#pragma unroll 1\n    for (int dg = 0; dg < DG; ++dg) {"
# the streamed forward with the whole-head kernel's warp-owned rows: each warp
# works P V on its own 8 rows of the p tile (the upper half of m16n8k16's A,
# all DH columns), so the p tile needs no block barrier
_STREAM_PV_OWNED = [
    ("""  const int rt = 16 * (warp >> 1), half = warp & 1;
  const bool pv = q0 + rt < s_len;  // the same for the whole warp
  float out[DH / 16][4];
  zero(out);""", """  float out[DH / 8][4];  // the warp's 8 rows, all DH columns
  zero(out);"""),
    ("""    __syncthreads();  // the p tile complete
    if (pv) {
      for (int ks = 0; 16 * ks < valid; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, smem_addr(p_s + (rt + (lane & 15)) * kPPitch + 16 * ks + ((lane >> 4) << 3)));
        weighted<DH, DH / 32>(out, a, v_s, 16 * ks, half * (DH / 32), lane);
      }
    }""", """    __syncwarp();  // the warp's own rows of the p tile
    if (live) {
      for (int ks = 0; 16 * ks < valid; ++ks) {
        uint32_t a[4] = {0u, 0u, 0u, 0u};
        ldsm_x2(a[0], a[2], smem_addr(p_s + (r0 + (lane & 7)) * kPPitch + 16 * ks + ((lane >> 3) & 1) * 8));
        weighted<DH, DH / 16>(out, a, v_s, 16 * ks, 0, lane);
      }
    }"""),
    ("""  if (pv) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
      for (int n = 0; n < DH / 16; ++n) {
        *reinterpret_cast<uint32_t*>(o_s + swz<DH>(rt + g + 8 * hr, half * (CH / 2) + n) + 2 * t) =
            pack_bf16(out[n][2 * hr], out[n][2 * hr + 1]);
      }
    }
  }
  __syncthreads();""", """  __syncthreads();  // every warp's last read of q_f done
  if (live) {
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      *reinterpret_cast<uint32_t*>(o_s + swz<DH>(r0 + g, n) + 2 * t) = pack_bf16(out[n][0], out[n][1]);
    }
  }
  __syncthreads();"""),
]
ROUNDED_VARIANTS = {
    "kernel": [],
    "streamed at any length": [("constexpr int kWholeMaxSeq = 256;", "constexpr int kWholeMaxSeq = 0;")],
    "three sweeps": [("constexpr int kCacheMaxKeys = 1 << 20;", "constexpr int kCacheMaxKeys = 0;")],
    "128-key tiles": [("constexpr int kKeyTile = 64;", "constexpr int kKeyTile = 128;")],
    "128-key tiles, 3 blocks an SM": [("constexpr int kKeyTile = 64;", "constexpr int kKeyTile = 128;"),
                                      ("constexpr int kFwdBlocksPerSm = 4;", "constexpr int kFwdBlocksPerSm = 3;")],
    "whole head, groups of 8 rows": [("constexpr int kWholeRows = 16;", "constexpr int kWholeRows = 8;")],
    "streamed, warp-owned P V rows": _STREAM_PV_OWNED,
    "whole head, 5 warps a block": [("constexpr int kWholeWarps = 4;", "constexpr int kWholeWarps = 5;")],
    "whole head, last chunk a key a lane": [("constexpr bool narrow_tail(int kv) { return kv > 32 &&",
                                             "constexpr bool narrow_tail(int kv) { return false &&")],
    "whole head, score loop unrolled 2": [(_SCORE_LOOP, _SCORE_LOOP.replace("unroll 1", "unroll 2"))],
}
# diagnostics of the whole-head kernel: copies with a phase cut out, timed at
# the packed entry's main shape beside the kernel (their output is not the
# function's; only their time is read)
_NO_EXP = [("numerator(s[r][c], mx[r])", "__fsub_rn(s[r][c], mx[r])"),
           ("div_unit(s[r][c], sum[r])", "__fmul_rn(s[r][c], sum[r])")]
_NO_PV = [("const int steps = kvp / 16;", "const int steps = 0;")]
ROUNDED_DIAGNOSTICS = {
    "no exp or division": _NO_EXP,
    "no P V": _NO_PV,
    "scores and p stores only": [*_NO_EXP, *_NO_PV, ("for (int off = 16; off > 0; off >>= 1) {",
                                                     "for (int off = 16; off > 16; off >>= 1) {")],
    "K staged without loads": [("if (idx < KEYS * CH && key < kv) {", "if (false) {")],
    "P V, V without .trans": [("ldsm_x4_trans(va[mt], v_addr[mt] + 32 * DH * ks)", "ldsm_x4(va[mt], v_addr[mt] + 32 * DH * ks)")],
    "P V, mma on the first step's fragments": [
        ("if (ks + 1 < steps) load_step(pf[1], vf[1], ks + 1);", "if (false) load_step(pf[1], vf[1], ks + 1);"),
        ("if (ks + 2 < steps) load_step(pf[0], vf[0], ks + 2);", "if (false) load_step(pf[0], vf[0], ks + 2);")],
    "P V, loads without mma": [("mma_bf16(acc[n][mt], va[mt], pb[2 * n], pb[2 * n + 1]);",
                                "acc[n][mt][0] += __uint_as_float((va[mt][0] ^ va[mt][3]) & pb[2 * n] & 0x3f800000u);")],
}
ROUNDED_ENTRIES = ENTRIES.replace("attention_fwd_bf16", "attention_rounded_fwd_bf16").replace(
    "attention_bwd_bf16", "attention_rounded_bwd_bf16") + r'''
extern "C" int variant_qkv_fwd(const void* qkv, void* o, int batch, int heads, int s, int dh, int kv,
                               float scale, void* stream) {
  return attention_qkv_fwd_bf16(qkv, o, batch, heads, s, dh, kv, scale, static_cast<cudaStream_t>(stream));
}
'''
PACKED_SHAPE = (128, 197, 12, 64)  # the packed entry's main path: batch, tokens, heads, head width
# vit_b16's heads at 224², 256², 384², 512² and 576², and 1024 tokens
ROUNDED_SHAPES = ((128, 12, 197, 64), (64, 12, 257, 64), (16, 12, 577, 64), (4, 12, 1024, 64), (4, 12, 1025, 64),
                  (2, 12, 1297, 64))

F32_SOURCE = CSRC_DIR / "attention_f32_mma.cu"
F32_VARIANTS = {
    "kernel": [],
    "cvt.rna split": [("  hi = __float_as_uint(x) & 0xffffe000u;\n  lo = __float_as_uint(x - __uint_as_float(hi));",
                       "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(hi) : \"f\"(x));\n"
                       "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(lo) : \"f\"(x - __uint_as_float(hi)));")],
    "every tile guarded": [("if (valid == kTile) {", "if (false) {"), ("if (valid == kBwdTile) {", "if (false) {")],
    "2 blocks an SM": [("constexpr int kBlocksPerSm = 3;", "constexpr int kBlocksPerSm = 2;")],
    "3 stages": [("constexpr int kStages = 2;", "constexpr int kStages = 3;"),
                 ("constexpr int kBlocksPerSm = 3;", "constexpr int kBlocksPerSm = 2;")],
    "bwd 64-row blocks and tiles": [("constexpr int kBwdWarps = 2;", "constexpr int kBwdWarps = 4;"),
                                    ("constexpr int kBwdTile = 32;", "constexpr int kBwdTile = 64;"),
                                    ("constexpr int kRowsBlocksPerSm = 4;", "constexpr int kRowsBlocksPerSm = 2;"),
                                    ("constexpr int kKeysBlocksPerSm = 4;", "constexpr int kKeysBlocksPerSm = 2;")],
    "bwd ragged 32-column steps": [("constexpr int kRaggedStep = 16;", "constexpr int kRaggedStep = 32;")],
    "bwd one accumulator": [("  float part[DH / 8][4];\n  zero(part);\n  weighted<DH, NT>(part,",
                             "  weighted<DH, NT>(acc, p, b_s, row0, lim, g, t);\n  return;\n"
                             "  float part[DH / 8][4];\n  zero(part);\n  weighted<DH, NT>(part,")],
}
F32_ENTRIES = r'''
extern "C" int variant_fwd(const void* q, const void* k, const void* v, void* o, void* stats, int bh, int s,
                           int dh, float scale, void* stream) {
  return attention_fwd_f32(q, k, v, o, stats, bh, s, dh, scale, static_cast<cudaStream_t>(stream));
}
extern "C" int variant_bwd(const void* q, const void* k, const void* v, const void* d_o, void* dq, void* dk,
                           void* dv, const void* o, const void* stats, void* delta, int bh, int s, int dh,
                           float scale, void* stream) {
  return attention_bwd_f32(q, k, v, d_o, dq, dk, dv, o, stats, delta, bh, s, dh, scale,
                           static_cast<cudaStream_t>(stream));
}
'''
# (batch, heads, tokens, head width): chip_smoke.py's float32 [attn4] shapes,
# and 192 tokens (197 without the ragged fourth 64-row block)
F32_SHAPES = ((128, 12, 197, 64), (128, 12, 192, 64), (128, 12, 256, 64), (16, 12, 577, 64), (8, 2, 50, 32))


def build_variants(source=SOURCE, variants=VARIANTS, entries_src=ENTRIES, f32: bool = False) -> dict:
    """name -> (forward, backward) C entries (and the packed forward where
    ``entries_src`` has one), built in parallel."""
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
        # the float32 entries take the row statistics (forward), o, the
        # statistics and the delta scratch (backward); bf16 one scratch
        handle.variant_fwd.argtypes = [p] * (5 if f32 else 4) + [i, i, i, f, p]
        handle.variant_bwd.argtypes = [p] * (10 if f32 else 8) + [i, i, i, f, p]
        entries[name] = (handle.variant_fwd, handle.variant_bwd)
        if "variant_qkv_fwd" in entries_src:
            handle.variant_qkv_fwd.argtypes = [p, p, i, i, i, i, i, f, p]
            entries[name] += (handle.variant_qkv_fwd,)
    return entries


def calls(entry, q, k, v, d_o):
    """The variant's forward and backward on these operands, as closures;
    in float32 a third, the forward that writes the row statistics the
    backward reads (call it before the backward)."""
    b, h, s, dh = q.shape
    f32 = q.dtype == torch.float32
    o, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
    sp = -(-s // 16) * 16
    stats = torch.empty(b * h * 2 * sp, device=q.device)
    scratch = torch.empty(b * h * (1 if f32 else 3) * sp, device=q.device)
    stream = torch.cuda.current_stream().cuda_stream
    args = (b * h, s, dh, _scale(dh), stream)

    def fwd(with_stats: bool = False):
        extra = (stats.data_ptr() if with_stats else None,) if f32 else ()
        if entry[0](q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *extra, *args):
            raise RuntimeError("variant forward launch failed")

    def bwd():
        extra = (o.data_ptr(), stats.data_ptr()) if f32 else ()
        if entry[1](q.data_ptr(), k.data_ptr(), v.data_ptr(), d_o.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), *extra, scratch.data_ptr(), *args):
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


def device_ms(fn, reps: int = 5) -> dict:
    """Device time a call of ``fn`` by kernel (``torch.profiler``), for the
    kernels named attn_*_kernel."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        name = re.search(r"attn_\w+?_kernel", e.name)
        if e.device_type == torch.autograd.DeviceType.CUDA and name:
            out[name[0]] = out.get(name[0], 0.0) + (e.time_range.end - e.time_range.start) / 1000.0 / reps
    return out


def clocks_under(fn, seconds: float = 2.0) -> tuple:
    """(median SM clock in MHz, median power draw in W) that ``nvidia-smi``
    reads every 100 ms while ``fn`` runs back to back for ``seconds``."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
                            "-lms", "100"], stdout=subprocess.PIPE, text=True)
    try:
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
    rows = [line.split(",") for line in smi.communicate()[0].splitlines() if line.count(",") == 1]
    return tuple(float(np.median([float(row[i]) for row in rows[2:-1] or rows])) for i in range(2))


def main_f32() -> None:
    """The float32 kernels' variants: each checked against the plain
    versions at [4, 12, 197, 64] (output within 2e-5, gradients within 1e-5
    of each one's largest entry; a variant outside is printed and not
    timed), then timed at ``F32_SHAPES`` beside SDPA (forward without
    statistics, backward from the forward's output and statistics)."""
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in true float32
    entries = build_variants(F32_SOURCE, F32_VARIANTS, F32_ENTRIES, f32=True)
    rng = np.random.default_rng(0)
    operands = [torch.from_numpy(rng.standard_normal((4, 12, 197, 64)).astype(np.float32)).cuda() for _ in range(4)]
    refs = (attention_unrounded_plain(*operands[:3]), *attention_bwd_plain(*operands))
    for name, entry in list(entries.items()):
        fwd, bwd, outs = calls(entry, *operands)
        fwd(with_stats=True)
        bwd()
        torch.cuda.synchronize()
        err = (outs[0] - refs[0]).abs().max().item()
        rels = [((g - r).abs().max() / r.abs().max()).item() for g, r in zip(outs[1:], refs[1:])]
        held = err <= 2e-5 and max(rels) <= 1e-5
        print(f"[variants] variant={name.replace(' ', '_')} max_abs_err={err:.3g} "
              f"grad_rel={'/'.join(f'{r:.3g}' for r in rels)} within_gates={held}")
        if not held:  # not timed
            if name == "kernel":
                raise AssertionError(f"the kernel is {err} and {rels} off the plain versions, allowed 2e-5, 1e-5")
            del entries[name]
    for shape in F32_SHAPES:
        q, k, v, d_o = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda() for _ in range(4))
        times = {name: ([], []) for name in entries}
        for name in [*entries, *reversed(entries)]:
            fwd, bwd, _ = calls(entries[name], q, k, v, d_o)
            times[name][0].append(median_ms(fwd))
            fwd(with_stats=True)
            times[name][1].append(median_ms(bwd))
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        o_lib = F.scaled_dot_product_attention(*leaves)
        print(f"[variants] shape={'x'.join(map(str, shape))} variant=sdpa "
              f"fwd_ms={median_ms(lambda: F.scaled_dot_product_attention(q, k, v)):.4f} "
              f"bwd_ms={median_ms(lambda: torch.autograd.grad(o_lib, leaves, d_o, retain_graph=True)):.4f}")
        for name, (f_ms, b_ms) in times.items():
            print(f"[variants] shape={'x'.join(map(str, shape))} variant={name.replace(' ', '_')} "
                  f"fwd_ms={min(f_ms):.4f} bwd_ms={min(b_ms):.4f}", flush=True)
        fwd, bwd, _ = calls(entries["kernel"], q, k, v, d_o)
        fwd(with_stats=True)
        split = {**device_ms(lambda: fwd(with_stats=True)), **device_ms(bwd)}
        print(f"[variants] shape={'x'.join(map(str, shape))} variant=kernel device_ms "
              + " ".join(f"{n}={ms:.4f}" for n, ms in split.items()), flush=True)
        del q, k, v, d_o, leaves, o_lib
        torch.cuda.empty_cache()


def main(rounded: bool = False) -> None:
    """The bf16 kernels' variants, checked at [4, 12, 197, 64] and then
    timed at each shape beside SDPA. The unpacked pair's are held to one bf16
    step (output and gradients, element by element); the rounded pair's to
    one step of ``attention_plain`` and its gradients to 1e-2 of each one's
    largest entry, the packed pair's gates."""
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in true float32
    entries = (build_variants(ROUNDED_SOURCE, {**ROUNDED_VARIANTS, **ROUNDED_DIAGNOSTICS}, ROUNDED_ENTRIES)
               if rounded else build_variants())
    diagnostics = {name: entries.pop(name) for name in ROUNDED_DIAGNOSTICS} if rounded else {}
    rng = np.random.default_rng(0)
    operands = [torch.from_numpy(rng.standard_normal((4, 12, 197, 64)).astype(np.float32)).cuda().bfloat16()
                for _ in range(4)]
    if rounded:
        refs = (attention_plain(*operands[:3]), *attention_rounded_bwd_plain(*operands))
    else:
        refs = (attention_unrounded_plain(*operands[:3]), *attention_bwd_plain(*operands))
    for name, entry in entries.items():
        fwd, bwd, outs = calls(entry, *operands)
        fwd()
        bwd()
        torch.cuda.synchronize()
        held = (within_one_step(outs[0], refs[0]) and all(
            ((g.float() - r.float()).abs().max() <= 1e-2 * r.float().abs().max()).item()
            for g, r in zip(outs[1:], refs[1:]))) if rounded else all(
            within_one_step(got, ref) for got, ref in zip(outs, refs))
        if not held:
            raise AssertionError(f"variant {name!r} is not within the bf16 gates of the plain versions")
    if rounded:  # the packed entry at its main path's shape
        b, s, heads, dh = PACKED_SHAPE
        qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * heads * dh)).astype(np.float32)).cuda().bfloat16()
        o = torch.empty((b, s, heads * dh), dtype=torch.bfloat16, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def packed(entry):
            if entry[2](qkv.data_ptr(), o.data_ptr(), b, heads, s, dh, s, _scale(dh), stream):
                raise RuntimeError("variant packed forward launch failed")

        ref = attention_qkv_plain(qkv, heads)
        for name, entry in entries.items():
            packed(entry)
            if not within_one_step(o, ref):
                raise AssertionError(f"variant {name!r}: the packed forward is not within one bf16 step")
        timed = {**entries, **diagnostics}
        packed_ms = {name: [] for name in timed}
        for name in [*timed, *reversed(timed)]:
            packed_ms[name].append(median_ms(lambda: packed(timed[name])))
        for name, ms in packed_ms.items():
            print(f"[variants] packed_shape={b}x{s}x{3 * heads * dh} variant={name.replace(' ', '_')} "
                  f"fwd_ms={min(ms):.4f} diagnostic={int(name in diagnostics)}", flush=True)
        device = device_ms(lambda: packed(entries["kernel"]))
        print(f"[variants] packed_shape={b}x{s}x{3 * heads * dh} variant=kernel device_ms "
              + " ".join(f"{n}={ms:.4f}" for n, ms in device.items()), flush=True)
        clocks = clocks_under(lambda: packed(entries["kernel"]))
        print(f"[variants] packed_shape={b}x{s}x{3 * heads * dh} variant=kernel under_load "
              f"sm_clock_mhz={clocks[0]:.0f} power_w={clocks[1]:.1f}", flush=True)
    for shape in ROUNDED_SHAPES if rounded else SHAPES:
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
    main_f32() if "--f32" in sys.argv[1:] else main(rounded="--rounded" in sys.argv[1:])
