"""Time variants of ``csrc/qmlp.cu`` (the int8 MLP's two kernels) against
each other on one card: what PERF.md's design notes for them rest on.

Each variant is a copy of the source with some of its tile constants
replaced, built by nvcc into ``build/ssip_tpu_torch/variants/`` (its C
entries ``ssip_qmlp_hidden`` and ``ssip_qmlp_output`` are the source's own),
and checked against the plain versions at 1,001 rows of width 768 (the int8
hidden within one step at no more than 1e-3 of the values, the output
bitwise on the same hidden) before it is timed; a diagnostic variant that
computes another function on purpose (``DIAGNOSTIC``) is only timed. Every variant then runs
both kernels at [25216, 768] bfloat16, hidden 3072 (``vit_b16``'s MLP at
128 images) in turns (first to last, last to first), and the smaller of
its two medians of CUDA-event times is printed for each kernel, beside the
two ``torch._int_mm`` products of the same GEMMs.

    python -m ssip_tpu_torch.kernels.qmlp_variants   # one CUDA card
"""

from __future__ import annotations

import ctypes
import subprocess
from types import SimpleNamespace

import numpy as np
import torch

from ssip_tpu_torch.kernels.build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, find_nvcc
from ssip_tpu_torch.ops.qmlp import qmlp_hidden_plain, qmlp_output_plain
from ssip_tpu_torch.ops.quant import QuantSite, quantize

SOURCE = CSRC_DIR / "qmlp.cu"
VARIANTS = {
    "kernel": [],
    "hidden 64x128 tiles, 3 blocks an SM": [("constexpr int kHidCols = 256;", "constexpr int kHidCols = 128;"),
                                            ("constexpr int kHidBlocksPerSm = 2;", "constexpr int kHidBlocksPerSm = 3;")],
    "hidden 128x256 tiles, 1 block an SM": [("constexpr int kHidRows = 64;", "constexpr int kHidRows = 128;"),
                                            ("constexpr int kHidBlocksPerSm = 2;", "constexpr int kHidBlocksPerSm = 1;")],
    "output 64-byte steps, 4 stages": [("constexpr int kOutK = 128;", "constexpr int kOutK = 64;"),
                                       ("constexpr int kOutStages = 3;", "constexpr int kOutStages = 4;")],
    "output 128x256 tiles, 1 block an SM": [("constexpr int kOutCols = 128;", "constexpr int kOutCols = 256;"),
                                            ("constexpr int kOutBlocksPerSm = 2;", "constexpr int kOutBlocksPerSm = 1;")],
    # what the GELU costs the hidden kernel: requantize h itself (wrong results, timed only)
    "no GELU": [("quantize(gelu_erf(h0), inv2) | (quantize(gelu_erf(h1), inv2) << 8)",
                 "quantize(h0, inv2) | (quantize(h1, inv2) << 8)")],
}
DIAGNOSTIC = {"no GELU"}  # variants that compute another function: not checked, only timed
ROWS, WIDTH, HIDDEN = 128 * 197, 768, 3072
TIMED = 20


def build_variants() -> dict:
    """name -> (hidden entry, output entry), built in parallel."""
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
        cu = out_dir / f"qmlp_variant{i}.cu"
        cu.write_text(src)
        lib = out_dir / f"qmlp_variant{i}.so"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-shared", "-o", str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    entries = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{log}")
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"[qmlp_variants] variant={name.replace(' ', '_')} ptxas: {line.strip()}")
        handle = ctypes.CDLL(str(lib))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        handle.ssip_qmlp_hidden.argtypes = [p, i, p, p, p, p, i, i, i, f, f, p]
        handle.ssip_qmlp_output.argtypes = [p, p, p, p, p, i, i, i, p]
        entries[name] = (handle.ssip_qmlp_hidden, handle.ssip_qmlp_output)
    return entries


def block(rng, d: int, hidden: int) -> SimpleNamespace:
    """Two int8 sites whose scales keep the hidden values O(1), on the card."""

    def site(cin, cout, mult):
        return QuantSite(
            rng.integers(-127, 128, (cin, cout)).astype(np.int8), (mult * rng.uniform(0.5, 1.5, cout)).astype(np.float32),
            rng.normal(0.0, 0.1, cout).astype(np.float32), np.float32(127.0 / 4.0), transposed=True,
        ).cuda()

    return SimpleNamespace(mlp_1=site(d, hidden, 1.0 / (np.sqrt(d) * 32.0 * 73.0)),
                           mlp_2=site(hidden, d, 1.0 / (np.sqrt(hidden) * 25.0 * 73.0)))


def calls(entry, y: torch.Tensor, blk):
    """The variant's two kernels on ``y`` as closures, and their outputs."""
    rows, d = y.shape
    hidden = blk.mlp_1.kernel_t.shape[0]
    gq = torch.empty((rows, hidden), dtype=torch.int8, device=y.device)
    out = torch.empty((rows, d), dtype=torch.float32, device=y.device)
    m1, m2 = blk.mlp_1, blk.mlp_2
    stream = torch.cuda.current_stream().cuda_stream

    def hid():
        if entry[0](y.data_ptr(), int(y.dtype == torch.bfloat16), m1.kernel_t.data_ptr(), m1.mult.data_ptr(),
                    m1.bias.data_ptr(), gq.data_ptr(), rows, d, hidden, m1.inv_scale, m2.inv_scale, stream):
            raise RuntimeError("variant hidden launch failed")

    def output():
        if entry[1](gq.data_ptr(), m2.kernel_t.data_ptr(), m2.mult.data_ptr(), m2.bias.data_ptr(), out.data_ptr(),
                    rows, d, hidden, stream):
            raise RuntimeError("variant output launch failed")

    return hid, output, (gq, out)


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


def main() -> None:
    entries = build_variants()
    rng = np.random.default_rng(0)
    blk = block(rng, WIDTH, HIDDEN)
    check = torch.from_numpy(rng.standard_normal((1001, WIDTH)).astype(np.float32)).cuda().bfloat16()
    ref_gq = qmlp_hidden_plain(check, blk)
    for name, entry in entries.items():
        if name in DIAGNOSTIC:
            continue
        hid, output, (gq, out) = calls(entry, check, blk)
        hid()
        output()
        torch.cuda.synchronize()
        diff = (gq.int() - ref_gq.int()).abs()
        if diff.max().item() > 1 or diff.count_nonzero().item() > 1e-3 * gq.numel():
            raise AssertionError(f"variant {name!r}: the int8 hidden is off its plain version")
        if not torch.equal(out, qmlp_output_plain(gq, blk)):
            raise AssertionError(f"variant {name!r}: the output is not its plain version's")
    y = torch.from_numpy(rng.standard_normal((ROWS, WIDTH)).astype(np.float32)).cuda().bfloat16()
    times = {name: ([], []) for name in entries}
    for name in [*entries, *reversed(entries)]:
        hid, output, _ = calls(entries[name], y, blk)
        times[name][0].append(median_ms(hid))
        times[name][1].append(median_ms(output))
    xq, gq = quantize(y, blk.mlp_1.inv_scale), qmlp_hidden_plain(y, blk)
    ops = 2 * ROWS * WIDTH * HIDDEN  # of each product
    int_mm = (median_ms(lambda: torch._int_mm(xq, blk.mlp_1.kernel)), median_ms(lambda: torch._int_mm(gq, blk.mlp_2.kernel)))
    print(f"[qmlp_variants] shape={ROWS}x{WIDTH} hidden={HIDDEN} variant=int_mm hidden_ms={int_mm[0]:.4f} "
          f"output_ms={int_mm[1]:.4f}")
    for name, (h_ms, o_ms) in times.items():
        h, o = min(h_ms), min(o_ms)
        print(f"[qmlp_variants] shape={ROWS}x{WIDTH} hidden={HIDDEN} variant={name.replace(' ', '_')} "
              f"hidden_ms={h:.4f} output_ms={o:.4f} total_ms={h + o:.4f} hidden_tops={ops / h / 1e9:.1f} "
              f"output_tops={ops / o / 1e9:.1f}", flush=True)


if __name__ == "__main__":
    main()
