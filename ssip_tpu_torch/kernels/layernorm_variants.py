"""Time variants of ``csrc/layernorm.cu`` (the LayerNorm pair) against each
other on one card: what PERF.md's design notes for those kernels rest on.

Each variant is a copy of the source with some of its lines replaced (a
constant, the launch bounds, or the way a warp walks its rows), built by
nvcc into ``build/ssip_tpu_torch/variants/`` (one process each, all started
together), and checked against the plain versions at the main path's shape
(the output within one bfloat16 step or 2e-5, the gradients within 1e-2 or
1e-5 of each tensor's largest entry) before it is timed. Every variant then
runs in turns (first to last, last to first) and the smaller of its two
medians of device time (``torch.profiler``, 20 launches) is printed: the
forward kernel, and the backward kernel plus its column sum.

    python -m ssip_tpu_torch.kernels.layernorm_variants     # one CUDA card
"""

from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import torch

from ssip_tpu_torch.kernels.build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, find_nvcc
from ssip_tpu_torch.ops.layernorm import LN_EPS, layer_norm_bwd_plain, layer_norm_plain

SOURCE = CSRC_DIR / "layernorm.cu"
_CONTIGUOUS_WALK = '''    first = static_cast<int>(w * n / warps);
    last = static_cast<int>((w + 1) * n / warps);
    steps = (last - first + rows_a_step - 1) / rows_a_step;
  }
  // The row that row group `group` takes at `step`; live if one of the warp's.
  __device__ int row(int step, int group) const { return first + step * rows_a_step + group; }'''
# warp w takes steps w, w + warps, ...: all warps on one moving window of rows
_INTERLEAVED_WALK = '''    first = static_cast<int>(w);
    last = n;
    const long long chunks = (n + rows_a_step - 1) / rows_a_step;
    steps = chunks > w ? static_cast<int>((chunks - w + warps - 1) / warps) : 0;
    stride = static_cast<int>(warps);
  }
  int stride;
  __device__ int row(int step, int group) const { return (first + step * stride) * rows_a_step + group; }'''
_FWD, _BWD = "constexpr int kFwdStages = 2;", "constexpr int kBwdStages = 4;"
# the forward's scale and bias in shared memory, loaded once a block: 49
# registers in place of 94, 9 blocks an SM in place of 5
_PARAMS_IN_SMEM = [
    ("  const size_t partials = 2 * static_cast<size_t>(d) * sizeof(float);  // backward's block sums\n"
     "  return tensors == 2 && partials > ring ? partials : ring;",
     "  const size_t partials = 2 * static_cast<size_t>(d) * sizeof(float);\n"
     "  return tensors == 1 ? ring + partials : (partials > ring ? partials : ring);"),
    ("    const float4 t = __ldg(reinterpret_cast<const float4*>(p) + i);",
     "    const float4 t = reinterpret_cast<const float4*>(p)[i];"),
    ("  float sc[L::kPerLane][N], bi[L::kPerLane][N];\n"
     "  load_params<T, D>(scale, nvec, lane_in_row, sc);\n"
     "  load_params<T, D>(bias, nvec, lane_in_row, bi);\n",
     "  float* s_scale = reinterpret_cast<float*>(smem + kWarps * kFwdStages * slot_elems<T, D>(d, 1) * sizeof(T));\n"
     "  float* s_bias = s_scale + d;\n"
     "  for (int i = threadIdx.x; i < d / 4; i += kThreads) {\n"
     "    reinterpret_cast<float4*>(s_scale)[i] = reinterpret_cast<const float4*>(scale)[i];\n"
     "    reinterpret_cast<float4*>(s_bias)[i] = reinterpret_cast<const float4*>(bias)[i];\n"
     "  }\n"
     "  __syncthreads();\n"),
    ("          float out[N];\n"
     "#pragma unroll\n"
     "          for (int k = 0; k < N; ++k) {\n"
     "            out[k] = __fadd_rn(__fmul_rn(__fmul_rn(v[it][k], r), sc[it][k]), bi[it][k]);",
     "          float sc[N], bi[N], out[N];\n"
     "          load_param<N>(s_scale + c * N, sc);\n"
     "          load_param<N>(s_bias + c * N, bi);\n"
     "#pragma unroll\n"
     "          for (int k = 0; k < N; ++k) {\n"
     "            out[k] = __fadd_rn(__fmul_rn(__fmul_rn(v[it][k], r), sc[k]), bi[k]);"),
]
VARIANTS = {
    "kernel": [],
    "fwd parameters in shared memory": _PARAMS_IN_SMEM,
    "no ring (1 stage)": [(_FWD, "constexpr int kFwdStages = 1;"), (_BWD, "constexpr int kBwdStages = 1;")],
    "3 stages (the first form)": [(_FWD, "constexpr int kFwdStages = 3;"), (_BWD, "constexpr int kBwdStages = 3;")],
    "fwd 4 stages": [(_FWD, "constexpr int kFwdStages = 4;")],
    "bwd 2 stages": [(_BWD, "constexpr int kBwdStages = 2;")],
    "8 warps a block": [("constexpr int kWarps = 4;", "constexpr int kWarps = 8;")],
    "interleaved rows": [(_CONTIGUOUS_WALK, _INTERLEAVED_WALK)],
    "bwd 3 blocks an SM": [("__launch_bounds__(kThreads)\n    ln_bwd_kernel", "__launch_bounds__(kThreads, 3)\n    ln_bwd_kernel")],
}
SHAPES = ((128 * 197, 768, torch.bfloat16), (128 * 197, 768, torch.float32))
TIMED = 20


def build_variants() -> dict:
    """name -> the variant's library (its ssip_layer_norm_* entries typed)."""
    out_dir = BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        src = text
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"variant {name!r}: {old!r} is not in {SOURCE.name}")
            src = src.replace(old, new)
        cu = out_dir / f"layernorm_variant{i}.cu"
        cu.write_text(src)
        lib = out_dir / f"layernorm_variant{i}.so"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-shared", "-o", str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{log}")
        handle = ctypes.CDLL(str(lib))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        handle.ssip_layer_norm_fwd.argtypes = [p, p, p, p, i, i, i, i, f, p]
        handle.ssip_layer_norm_bwd.argtypes = [p, p, p, p, p, p, i, i, i, i, f, p]
        handle.ssip_layer_norm_info.argtypes = [i, i, i, p]
        libs[name] = handle
    return libs


def info(lib, kernel: int, bf16: bool, d: int) -> list:
    """[registers, local bytes, shared memory a block, resident blocks an SM]."""
    out = (ctypes.c_int * 4)()
    err = lib.ssip_layer_norm_info(kernel, int(bf16), d, out)
    if err:
        raise RuntimeError(f"ssip_layer_norm_info: cudaError {err}")
    return list(out)


def calls(lib, x, scale, bias, dy):
    """The variant's forward and backward on these operands, one wave of
    blocks each (the wrapper's grid), as closures, and their outputs."""
    n, d = x.shape
    bf16 = x.dtype == torch.bfloat16
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    grids = [min(sms * info(lib, k, bf16, d)[3], n) for k in (0, 1)]
    y, dx = torch.empty_like(x), torch.empty_like(x)
    partials = torch.empty((2, grids[1], d), device=x.device)
    sums = torch.empty((2, d), device=x.device)
    stream = torch.cuda.current_stream().cuda_stream

    def fwd():
        if lib.ssip_layer_norm_fwd(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), int(bf16), n, d,
                                   grids[0], LN_EPS, stream):
            raise RuntimeError("variant forward launch failed")

    def bwd():
        if lib.ssip_layer_norm_bwd(x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(), partials.data_ptr(),
                                   sums.data_ptr(), int(bf16), n, d, grids[1], LN_EPS, stream):
            raise RuntimeError("variant backward launch failed")

    return fwd, bwd, (y, dx, sums)


def within_gates(x, scale, bias, dy, outputs) -> bool:
    y, dx, sums = outputs
    ref_y = layer_norm_plain(x, scale, bias, LN_EPS)
    err = (y.float() - ref_y.float()).abs()
    tol = torch.full_like(err, 2e-5)
    if x.dtype == torch.bfloat16:
        tol = torch.maximum(tol, torch.exp2(torch.floor(torch.log2(ref_y.float().abs().clamp_min(1e-30))) - 7))
    ok = bool((err <= tol).all())
    rtol = 1e-2 if x.dtype == torch.bfloat16 else 1e-5
    for got, ref in zip((dx, sums[0], sums[1]), layer_norm_bwd_plain(x, scale, dy, LN_EPS)):
        rel = (got.float() - ref.float()).abs().max() / ref.float().abs().max().clamp_min(1e-30)
        ok = ok and rel.item() <= (rtol if got is dx else 1e-5)
    return ok


def device_ms(fn) -> float:
    """Device time of a call of ``fn``: the median launch of each kernel it
    launches (``torch.profiler``), summed."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(TIMED):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name.setdefault(e.name, []).append((e.time_range.end - e.time_range.start) / 1000.0)
    if any(len(v) != TIMED for v in by_name.values()):
        raise RuntimeError(f"torch.profiler saw {({k: len(v) for k, v in by_name.items()})} in {TIMED} calls")
    return sum(sorted(v)[TIMED // 2] for v in by_name.values())


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("layernorm_variants needs an NVIDIA GPU")
    libs = build_variants()
    rng = np.random.default_rng(0)
    for n, d, dtype in SHAPES:
        x = torch.from_numpy(rng.normal(0.3, 1.5, (n, d)).astype(np.float32)).cuda().to(dtype)
        dy = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).cuda().to(dtype)
        scale = torch.from_numpy(rng.normal(1.0, 0.2, d).astype(np.float32)).cuda()
        bias = torch.from_numpy(rng.normal(0.0, 0.2, d).astype(np.float32)).cuda()
        runs = {}
        for name, lib in libs.items():
            fwd, bwd, outputs = calls(lib, x, scale, bias, dy)
            fwd()
            bwd()
            torch.cuda.synchronize()
            if not within_gates(x, scale, bias, dy, outputs):
                print(f"[variants] variant={name.replace(' ', '_')} shape={n}x{d} dtype={dtype} outside the gates")
                continue
            runs[name] = (fwd, bwd)
        times: dict = {name: ([], []) for name in runs}
        for order in (list(runs), list(runs)[::-1]):
            for name in order:
                times[name][0].append(device_ms(runs[name][0]))
                times[name][1].append(device_ms(runs[name][1]))
        nbytes = n * d * x.element_size()
        bf16 = dtype == torch.bfloat16
        for name, (f, b) in times.items():
            fwd_info, bwd_info = info(libs[name], 0, bf16, d), info(libs[name], 1, bf16, d)
            print(f"[variants] variant={name.replace(' ', '_')} shape={n}x{d} dtype={str(dtype)[6:]} "
                  f"fwd_device_ms={min(f):.4f} fwd_gb_per_s={2 * nbytes / min(f) / 1e6:.1f} "
                  f"bwd_device_ms={min(b):.4f} bwd_gb_per_s={3 * nbytes / min(b) / 1e6:.1f} "
                  f"fwd_registers={fwd_info[0]} fwd_blocks_per_sm={fwd_info[3]} "
                  f"bwd_registers={bwd_info[0]} bwd_blocks_per_sm={bwd_info[3]} bwd_local_bytes={bwd_info[1]}",
                  flush=True)


if __name__ == "__main__":
    main()
