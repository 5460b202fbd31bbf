"""Time variants of the rotation and preprocess kernels against each other
on one card: what PERF.md's design notes for ``csrc/rotation.cu`` and
``csrc/preproc.cu`` rest on.

Rotation: each variant is a copy of ``csrc/rotation.cu`` with its tiles
(``RotTile<T>``: rows, pixels and the static window that
``ops/rotate.py:largest_window_bytes`` gives them) replaced, built by nvcc
into ``build/ssip_tpu_torch/variants/`` (one process each, all started
together), checked bitwise against the plain versions at [128, 224, 224, 3]
and timed there in the three output types.

Preprocess: each variant is a band plan (``ops/preproc.py:BandPlan``) of
other band rows and columns than ``band_plan`` picks, run through the
built library's C entries; each is checked bitwise against the plain
version at [128, 512, 512, 3] → 256 → 224 and timed in the three outputs.

Every variant runs in turns (first to last, last to first) and the smaller
of its two medians of device time (``torch.profiler``, 20 launches) is
printed.

    python -m ssip_tpu_torch.kernels.resample_variants     # one CUDA card
"""

from __future__ import annotations

import ctypes
import re
import subprocess

import numpy as np
import torch

from ssip_tpu_torch.kernels.build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, find_nvcc
from ssip_tpu_torch.ops import preproc
from ssip_tpu_torch.ops.augment import augment_coeffs, rotate_nearest, train_augment
from ssip_tpu_torch.ops.quant import quantize
from ssip_tpu_torch.ops.resize import crop_weights, extraction_preprocess, normalize_constants
from ssip_tpu_torch.ops.rotate import ROTATE_TILES, largest_window_bytes
from ssip_tpu_torch.runtime.prng import augment_draws

# (uint8, bfloat16, float32) tiles as (rows, pixels); a thread's run is 16,
# 8 or 4 pixels and a block holds 256 threads
ROTATE_VARIANTS = {
    "kernel": {},
    "u8 64x64, bf16 32x64, f32 32x32 (square)": {torch.uint8: (64, 64), torch.bfloat16: (32, 64),
                                                 torch.float32: (32, 32)},
    "u8 32x128": {torch.uint8: (32, 128)},
    "u8 128x32, bf16 128x16, f32 128x8 (tall)": {torch.uint8: (128, 32), torch.bfloat16: (128, 16),
                                                 torch.float32: (128, 8)},
    "bf16 64x32, f32 8x128": {torch.bfloat16: (64, 32), torch.float32: (8, 128)},
}
# (band rows, band columns) at 512 → 256 → 224; "plan" is band_plan's own
PREPROC_VARIANTS = {"plan": None, "4 x 224": (4, 224), "16 x 224": (16, 224), "16 x 112": (16, 112),
                    "32 x 56": (32, 56), "8 x 112": (8, 112)}
_TYPE_NAMES = {torch.uint8: "uint8_t", torch.bfloat16: "__nv_bfloat16", torch.float32: "float"}
TIMED = 20


_H_PASS = "    if (K == 4) {\n      {\n        // a thread owns the pair"
_V_PASS = "    {\n      const int runs = (ncols + kPixels - 1) / kPixels;"
# diagnostics: copies of csrc/preproc.cu with a pass left out (their output
# is not the function's; only their time is read)
_STAGE_FIRST = "  if (id < p.bands) stage_window("
_STAGE_NEXT = "      stage_window(smem_raw + ((step + 1) & 1) * window"
PREPROC_DIAGNOSTICS = {
    "no staging (compute only)": [(_STAGE_FIRST, "  if (false) stage_window("),
                                  (_STAGE_NEXT, "      if (false) stage_window(smem_raw + ((step + 1) & 1) * window")],
    "no horizontal pass": [(_H_PASS, _H_PASS.replace("      {", "      if (false) {"))],
    "no vertical pass": [(_V_PASS, "    if (false) " + _V_PASS[4:])],
    "512 threads a block": [("constexpr int kThreads = 256;", "constexpr int kThreads = 512;")],
    "staging only": [(_H_PASS, _H_PASS.replace("      {", "      if (false) {")),
                     (_V_PASS, "    if (false) " + _V_PASS[4:])],
}


def _tile_line(dtype, rows: int, pixels: int) -> str:
    return (f"struct RotTile<{_TYPE_NAMES[dtype]}> {{\n  static constexpr int kH = {rows}, kW = {pixels}, "
            f"kWindowBytes = {largest_window_bytes(rows, pixels)};")


def _rotation_sources() -> dict:
    text = (CSRC_DIR / "rotation.cu").read_text()
    out = {}
    for name, tiles in ROTATE_VARIANTS.items():
        src = text
        for dtype, (rows, pixels) in tiles.items():
            pattern = re.compile(rf"struct RotTile<{re.escape(_TYPE_NAMES[dtype])}> \{{\n  static constexpr int "
                                 r"kH = \d+, kW = \d+, kWindowBytes = \d+;")
            src, n = pattern.subn(_tile_line(dtype, rows, pixels), src)
            if n != 1:
                raise RuntimeError(f"variant {name!r}: RotTile<{_TYPE_NAMES[dtype]}> is not in rotation.cu")
        out[name] = src
    return out


def _preproc_sources() -> dict:
    text = (CSRC_DIR / "preproc.cu").read_text()
    out = {}
    for name, subs in PREPROC_DIAGNOSTICS.items():
        src = text
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"diagnostic {name!r}: {old!r} is not in preproc.cu")
            src = src.replace(old, new)
        out[name] = src
    return out


def build_copies(sources: dict, stem: str) -> dict:
    """name -> the library built from that source text (nvcc, one process
    each, all started together)."""
    out_dir = BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, src) in enumerate(sources.items()):
        cu = out_dir / f"{stem}_variant{i}.cu"
        cu.write_text(src)
        lib = out_dir / f"{stem}_variant{i}.so"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-shared", "-o", str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def device_ms(fn) -> float:
    """Median device time of the one kernel a call of ``fn`` launches: the
    last ``TIMED`` launches of one ``torch.profiler`` session, after a
    lead-in of as many that is not read (a session that is not the
    process's first can lose its first records)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a session that lost more than its lead-in is run again
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(2 * TIMED):
                fn()
            torch.cuda.synchronize()
        events = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA)
        if len(events) >= TIMED:
            times = sorted((end - start) / 1000.0 for start, end in events[-TIMED:])
            return times[TIMED // 2]
    raise RuntimeError(f"torch.profiler saw {len(events)} kernels in {2 * TIMED} calls, three times")


def in_turns(runs: dict) -> dict:
    """name -> the smaller median of two passes, first to last and back."""
    times: dict = {name: [] for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            times[name].append(device_ms(runs[name]))
    return {name: min(t) for name, t in times.items()}


def rotation(stream) -> None:
    libs = build_copies(_rotation_sources(), "rotation")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for lib in libs.values():
        lib.ssip_rotate_u8.argtypes = [p, p, i, i, i, p, p]
        lib.ssip_train_augment_u8.argtypes = [p, p, i, i, i, i, p, f, f, f, f, f, f, p]
    shape = (128, 224, 224, 3)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).cuda()
    flip, angles = augment_draws(0, "variants", 0, 0, shape[0], 10.0)
    coeffs = torch.from_numpy(augment_coeffs(flip, angles)).cuda()
    off, sc = normalize_constants()
    norm = [float(v) for v in off] + [float(v) for v in sc]
    want = {torch.uint8: rotate_nearest(x, coeffs)}
    want[torch.float32] = train_augment(x, coeffs, torch.float32)
    want[torch.bfloat16] = want[torch.float32].to(torch.bfloat16)
    for dtype in (torch.uint8, torch.bfloat16, torch.float32):
        out = torch.empty(shape, dtype=dtype, device="cuda")
        runs = {}
        for name, lib in libs.items():
            if dtype == torch.uint8:
                def call(lib=lib):
                    assert lib.ssip_rotate_u8(x.data_ptr(), out.data_ptr(), *shape[:3], coeffs.data_ptr(), stream) == 0
            else:
                def call(lib=lib):
                    assert lib.ssip_train_augment_u8(x.data_ptr(), out.data_ptr(), int(dtype == torch.bfloat16),
                                                     *shape[:3], coeffs.data_ptr(), *norm, stream) == 0
            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want[dtype]):
                print(f"[variants] kernel=rotation variant={name.replace(' ', '_')} dtype={str(dtype)[6:]} "
                      "not bitwise", flush=True)
                continue
            runs[name] = call
        nbytes = x.numel() * (1 + out.element_size())
        for name, ms in in_turns(runs).items():
            tile = ROTATE_VARIANTS[name].get(dtype, ROTATE_TILES[dtype][:2])
            print(f"[variants] kernel=rotation variant={name.replace(' ', '_')} dtype={str(dtype)[6:]} "
                  f"tile={tile[0]}x{tile[1]} device_ms={ms:.4f} gb_per_s={nbytes / ms / 1e6:.1f}", flush=True)


def _plan(h: int, w: int, resize: int, crop: int, shape) -> preproc.BandPlan:
    wv, wh = crop_weights(h, w, resize, crop)
    return preproc._plan(preproc.tap_table(wv), preproc.tap_table(wh), *shape)


def _bind_preprocess(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tables = [p, p, p, i, p, p, p, i, f, f, f, f, f, f]
    lib.ssip_preprocess_u8.argtypes = [p, p, i, i, i, i, i, *tables, p, p, p]
    lib.ssip_preprocess_u8_quant.argtypes = [p, p, i, i, i, i, *tables, f, p, p, p]
    lib.ssip_preprocess_info.argtypes = [i, i, i, p]
    return lib.ssip_preprocess_u8, lib.ssip_preprocess_u8_quant, lib.ssip_preprocess_info


def preprocessing(stream) -> None:
    shape, resize, crop = (128, 512, 512, 3), 256, 224
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).cuda()
    inv = float(np.float32(127.0 / 2.64))
    ref = extraction_preprocess(x, resize, crop, torch.float32)
    want = {0: ref, 1: ref.to(torch.bfloat16), 2: quantize(ref, inv)}
    tables = preproc._device_tables(*shape[1:3], resize, crop, x.device)
    off, sc = normalize_constants()
    shared = (*(t.data_ptr() for t in tables[:3]), tables[2].shape[1], *(t.data_ptr() for t in tables[3:6]),
              tables[5].shape[1], *(float(v) for v in off), *(float(v) for v in sc))
    entries = {"kernel": (*preproc._kernel_entries(), preproc._info_entry())}
    entries.update({name: _bind_preprocess(lib) for name, lib in build_copies(_preproc_sources(), "preproc").items()})
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def launcher(kind, out, header, band_table, plain, quant, info):
        def call():
            if kind == 2:
                err = quant(x.data_ptr(), out.data_ptr(), *shape[:3], crop, *shared, inv, header,
                            band_table.data_ptr(), stream)
            else:
                err = plain(x.data_ptr(), out.data_ptr(), kind, *shape[:3], crop, *shared, header,
                            band_table.data_ptr(), stream)
            assert err == 0
        return call

    for kind in (1, 2, 0):
        out = torch.empty((shape[0], crop, crop, 3), dtype=want[kind].dtype, device="cuda")
        runs, notes = {}, {}
        for name, bands in PREPROC_VARIANTS.items():
            plan = preproc.band_plan(*shape[1:3], resize, crop) if bands is None else _plan(*shape[1:3], resize,
                                                                                               crop, bands)
            info = (ctypes.c_int * 4)()
            if preproc._info_entry()(kind, plan.taps, plan.smem_bytes, info) != 0 or info[3] == 0:
                print(f"[variants] kernel=preprocess variant={name.replace(' ', '_')} does not launch", flush=True)
                continue
            header = (ctypes.c_int * preproc.PLAN_WORDS)(*plan.header(sms * info[3]))
            wv, wh = crop_weights(*shape[1:3], resize, crop)
            band_table = torch.from_numpy(plan.tables(preproc.tap_table(wv), preproc.tap_table(wh))).cuda()
            call = launcher(kind, out, header, band_table, *entries["kernel"])
            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want[kind]):
                print(f"[variants] kernel=preprocess variant={name.replace(' ', '_')} kind={kind} not bitwise",
                      flush=True)
                continue
            runs[name] = call
            notes[name] = (f"band={plan.rows}x{plan.cols} smem_bytes={plan.smem_bytes} "
                           f"blocks_per_sm={info[3]} registers={info[0]} local_bytes={info[1]}")
            if bands is None:  # the diagnostics run at band_plan's own plan, one wave of their own blocks
                for diag in PREPROC_DIAGNOSTICS:
                    own = (ctypes.c_int * 4)()
                    assert entries[diag][2](kind, plan.taps, plan.smem_bytes, own) == 0
                    grid_header = (ctypes.c_int * preproc.PLAN_WORDS)(*plan.header(sms * own[3]))
                    runs[diag] = launcher(kind, out, grid_header, band_table, *entries[diag])
                    notes[diag] = (f"band={plan.rows}x{plan.cols} blocks_per_sm={own[3]} registers={own[0]} "
                                   "diagnostic=1")
        for name, ms in in_turns(runs).items():
            print(f"[variants] kernel=preprocess variant={name.replace(' ', '_')} "
                  f"out={('float32', 'bfloat16', 'int8')[kind]} {notes[name]} device_ms={ms:.4f}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("resample_variants needs an NVIDIA GPU")
    stream = torch.cuda.current_stream().cuda_stream
    preprocessing(stream)
    rotation(stream)


if __name__ == "__main__":
    main()
