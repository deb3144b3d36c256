#!/usr/bin/env python3
"""Probe the port's hand-written kernels on one NVIDIA GPU: the
tensor-core flash kernels (``blendjax_torch/ops/csrc/flash_fwd_tc.cu``,
the forward, and ``flash_bwd_tc.cu``, dQ and dK/dV) and the uint8 decode
(``decode.cu``): what the compiler gave each kernel, whether every bf16
flash case agrees with the plain passes at both output dtypes, the
flagship timings, where a forward, dQ or dK/dV tile's cycles go, and the
decode against the card's own copy rate and against other forms of it.

    python3 flash_bwd_probe.py                  # ptxas, check, phases, decode
    python3 flash_bwd_probe.py ptxas phases     # any subset, in that order
    python3 flash_bwd_probe.py ab=OTHER.cu      # another forward against the port's
    python3 flash_bwd_probe.py decode_ab=OTHER.cu   # another decode against the port's

ptxas  — ``nvcc -Xptxas -v`` on each source: registers and spill bytes of
         each kernel instance.
check  — every bf16 case of ``chip_smoke.FLASH_CASES`` with bf16 and with
         f32 outputs (the backward's f32 only under GQA) against
         ``flash_{fwd,dq,dkv}_plain`` at chip_smoke's limits, then
         ``chip_smoke.flash_time_phase`` at the flagship shape (both routes
         and the library call).
phases — an instrumented copy of each source (``clock64`` at the phase
         boundaries of each kernel's tile loop, summed over every block of
         one flagship launch) built beside the port's library and checked
         bit-equal to it; prints cycles per tile iteration by phase and the
         blocks per SM the occupancy calculator allows.
decode — ``nvcc -Xptxas -v`` on ``decode.cu`` (registers, spill and shared
         memory of each instance); at ``chip_smoke.MAIN_SHAPE`` the time of
         a device-to-device ``copy_`` that moves the decode's bytes (half
         of them read, half written: the card's practical rate for this
         traffic), the timing window's floor (no work between the events),
         the decode under other plans (chunk size, blocks per SM), each
         checked bit-equal to the plain decode, and the decode of the
         buffer from byte 1 (the unaligned path); each by
         ``chip_smoke.time_ms`` with the clean flush and by its kernels'
         own duration (``chip_smoke.profiled_us``).
ab     — another form of ``flash_fwd_tc.cu`` (any path, with the same C
         entry point) built beside the port's library: whether the two
         forwards agree bit for bit at the flagship shape, and their times
         there in turns (port, other, other, port, port, other) with
         ``chip_smoke.time_ms``, so that two designs are compared in one
         call on one card.
decode_ab — another form of ``decode.cu`` (the same C entry point, for
         example ``probes/decode_v1.cu`` or ``probes/decode_regs.cu``) built
         beside the port's library: its ptxas figures, whether it is
         bit-equal to the port's decode on every case of
         ``chip_smoke.decode_cases`` at both output dtypes and both
         ``linearize``, and the two times at the main shape in bf16 in
         turns (port, other, other, port, port, other) with the clean
         flush, then each kernel's own duration.

Builds go to ``build/probe``; a failed build or check exits nonzero.  The
instrumentation edits the sources at fixed lines of their loops and stops
with the line it could not find once those lines change.
"""

from __future__ import annotations

import ctypes
import math
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(REPO, "blendjax_torch", "ops", "csrc")
SOURCES = {"fwd": os.path.join(CSRC, "flash_fwd_tc.cu"),
           "bwd": os.path.join(CSRC, "flash_bwd_tc.cu")}
OUT = os.path.join(REPO, "build", "probe")
NVCC = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]


def ptxas():
    os.makedirs(OUT, exist_ok=True)
    for stem, source in SOURCES.items():
        _nvcc_report(source, ["-c", "-o", os.path.join(OUT, f"{stem}.o")])


def check():
    import torch

    import chip_smoke as cs
    from blendjax_torch.ops import flash_attention as flash

    g = torch.Generator(device="cuda").manual_seed(0)
    bad = 0
    for label, shape, h_kv, tk, dtype, causal, window, q_offset in cs.FLASH_CASES:
        if dtype != "bfloat16":
            continue
        b, t, h, d = shape
        qf, kf, vf, dof = cs._flash_inputs(torch, g, shape, h_kv, tk, dtype)
        heads = (h, h_kv) if h != h_kv else None
        kw = dict(window=window, q_offset=q_offset, heads=heads)
        scale = 1.0 / math.sqrt(d)
        of, lse = flash.flash_fwd_plain(qf, kf, vf, causal, scale, **kw)
        delta = (dof.float() * of.float()).sum(-1, keepdim=True)
        bwd = (qf, kf, vf, dof, lse, delta, causal, scale)
        for out_dtype in (None, torch.float32):
            got, want = {}, {}
            fkw = dict(kw, out_dtype=out_dtype)
            got["fwd"] = flash.flash_fwd_cuda(qf, kf, vf, causal, scale, **fkw)
            want["fwd"] = flash.flash_fwd_plain(qf, kf, vf, causal, scale, **fkw)
            if out_dtype is not None or not heads:
                got["dq"] = (flash.flash_dq_cuda(*bwd, **fkw),)
                want["dq"] = (flash.flash_dq_plain(*bwd, **fkw),)
                got["dkv"] = flash.flash_dkv_cuda(*bwd, **fkw)
                want["dkv"] = flash.flash_dkv_plain(*bwd, **fkw)
            torch.cuda.synchronize()
            for name in got:
                res = [cs._compare(torch, a, w, name != "fwd", heads is not None)
                       for a, w in zip(got[name], want[name])]
                ok = all(r[1] for r in res)
                bad += not ok
                print("ok " if ok else "BAD", name, label, out_dtype,
                      [f"{r[0]:.3g}" for r in res], flush=True)
    print("routes", cs._route_counts(flash))
    name = torch.cuda.get_device_name(0)
    cs.flash_time_phase(torch, flash, cs.peak_rate(cs.HBM_PEAK, name),
                        cs.peak_rate(cs.BF16_PEAK, name))
    if bad:
        raise SystemExit(f"flash_bwd_probe: {bad} checks failed")


# kernel -> (source, phase names, [(line in the tile loop, instrumented line)]);
# a kernel's counters are the row of its source's g_phases given by its
# place among that source's kernels here
_PHASES = {
    "flash_fwd_tc_kernel": (
        "fwd",
        ["tma wait", "S", "mask + softmax", "split", "P V", "sync, next TMA"],
        [("  mbar_wait(&bars[0], 0);\n  for (int i = 0; i < n; ++i) {\n",
          "  mbar_wait(&bars[0], 0);\n  unsigned long long ph[8] = {};\n"
          "  for (int i = 0; i < n; ++i) {\n    long long c_a = clock64();\n"),
         ("    mbar_wait(&bars[1 + s], (i >> 1) & 1);\n",
          "    mbar_wait(&bars[1 + s], (i >> 1) & 1);\n"
          "    long long c_b = clock64(); ph[0] += c_b - c_a;\n"),
         ("    fence_regs(sc);\n",
          "    fence_regs(sc);\n    long long c_c = clock64(); ph[1] += c_c - c_b;\n"),
         ("    uint32_t p_hi[16], p_lo[16];\n    split_hi_lo(sc, p_hi, p_lo);\n",
          "    long long c_d = clock64(); ph[2] += c_d - c_c;\n"
          "    uint32_t p_hi[16], p_lo[16];\n    split_hi_lo(sc, p_hi, p_lo);\n"
          "    long long c_e = clock64(); ph[3] += c_e - c_d;\n"),
         ("    fence_regs(p_lo);\n\n    __syncthreads();",
          "    fence_regs(p_lo);\n    long long c_f = clock64(); ph[4] += c_f - c_e;\n\n"
          "    __syncthreads();"),
         ("(first + i + 2) * kRows, bkv);\n    }\n  }\n",
          "(first + i + 2) * kRows, bkv);\n    }\n    ph[5] += clock64() - c_f; ph[7] += 1;\n  }\n"
          "  if (tid == 0) for (int k = 0; k < 8; ++k) atomicAdd(&g_phases[0][k], ph[k]);\n")]),
    "flash_dq_tc_kernel": (
        "bwd",
        ["tma wait", "S", "exp", "dP", "dS, split, dQ issue", "dQ drain", "sync, next TMA"],
        [("  mbar_wait(&bars[0], 0);\n  for (int i = 0; i < n; ++i) {\n",
          "  mbar_wait(&bars[0], 0);\n  unsigned long long ph[8] = {};\n"
          "  for (int i = 0; i < n; ++i) {\n    long long c_a = clock64();\n"),
         ("    mbar_wait(&bars[1 + s], (i >> 1) & 1);\n",
          "    mbar_wait(&bars[1 + s], (i >> 1) & 1);\n"
          "    long long c_b = clock64(); ph[0] += c_b - c_a;\n"),
         ("    fence_regs(sc);\n",
          "    fence_regs(sc);\n    long long c_c = clock64(); ph[1] += c_c - c_b;\n"),
         ("    wg_wait<0>();\n    fence_regs(dp);\n",
          "    long long c_d = clock64(); ph[2] += c_d - c_c;\n    wg_wait<0>();\n"
          "    fence_regs(dp);\n    long long c_e = clock64(); ph[3] += c_e - c_d;\n"),
         ("    gemm_rn<NC>(acc, ds_hi, ds_lo, tK);\n    wg_commit();\n",
          "    gemm_rn<NC>(acc, ds_hi, ds_lo, tK);\n    wg_commit();\n"
          "    long long c_f = clock64(); ph[4] += c_f - c_e;\n"),
         ("    fence_regs(ds_lo);\n\n    __syncthreads();",
          "    fence_regs(ds_lo);\n    long long c_g = clock64(); ph[5] += c_g - c_f;\n\n"
          "    __syncthreads();"),
         ("(first + i + 2) * kRows, bkv);\n    }\n  }\n",
          "(first + i + 2) * kRows, bkv);\n    }\n    ph[6] += clock64() - c_g; ph[7] += 1;\n  }\n"
          "  if (tid == 0) for (int k = 0; k < 8; ++k) atomicAdd(&g_phases[0][k], ph[k]);\n")]),
    "flash_dkv_tc_kernel": (
        "bwd",
        ["tma wait", "S^T", "exp, split, dV issue", "dP^T", "dS, split, dK issue",
         "dV and dK drain", "sync, next TMA"],
        [("  mbar_wait(&bars[0], 0);\n  for (int i = 0; i < n; ++i) {\n",
          "  mbar_wait(&bars[0], 0);\n  unsigned long long ph[8] = {};\n"
          "  for (int i = 0; i < n; ++i) {\n    long long c_a = clock64();\n"),
         ("    mbar_wait(&bars[1 + s], (i >> 1) & 1);\n",
          "    mbar_wait(&bars[1 + s], (i >> 1) & 1);\n"
          "    long long c_b = clock64(); ph[0] += c_b - c_a;\n"),
         ("    fence_regs(st);\n",
          "    fence_regs(st);\n    long long c_c = clock64(); ph[1] += c_c - c_b;\n"),
         ("    wg_wait<1>();  // dP^T has landed\n    fence_regs(dpt);\n",
          "    long long c_d = clock64(); ph[2] += c_d - c_c;\n"
          "    wg_wait<1>();  // dP^T has landed\n    fence_regs(dpt);\n"
          "    long long c_e = clock64(); ph[3] += c_e - c_d;\n"),
         ("    gemm_rn<NC>(acc_k, ds_hi, ds_lo, tQ);\n    wg_commit();\n",
          "    gemm_rn<NC>(acc_k, ds_hi, ds_lo, tQ);\n    wg_commit();\n"
          "    long long c_f = clock64(); ph[4] += c_f - c_e;\n"),
         ("    fence_regs(ds_lo);\n\n    __syncthreads();",
          "    fence_regs(ds_lo);\n    long long c_g = clock64(); ph[5] += c_g - c_f;\n\n"
          "    __syncthreads();"),
         ("(first + i + 2) * kRows, bh);\n    }\n  }\n",
          "(first + i + 2) * kRows, bh);\n    }\n    ph[6] += clock64() - c_g; ph[7] += 1;\n  }\n"
          "  if (tid == 0) for (int k = 0; k < 8; ++k) atomicAdd(&g_phases[1][k], ph[k]);\n")]),
}

# per source: its kernels at head dim 128 with their shared memory, for the
# occupancy calculator
_OCCUPANCY = {
    "fwd": [("flash_fwd_tc_kernel<bf16, 128>", "fwd_tc_smem<128>()")],
    "bwd": [("flash_dq_tc_kernel<bf16, 128>", "tc_smem<128>()"),
            ("flash_dkv_tc_kernel<bf16, 128>", "tc_smem<128>()")],
}

_PHASE_API = r'''
extern "C" int bjx_phases_read(unsigned long long* out) {
  return cudaMemcpyFromSymbol(out, bjx_flash::g_phases, sizeof(bjx_flash::g_phases));
}
extern "C" int bjx_phases_reset() {
  const unsigned long long zero[16] = {};
  return cudaMemcpyToSymbol(bjx_flash::g_phases, zero, sizeof(zero));
}
extern "C" int bjx_blocks_per_sm(int* out) {
  using namespace bjx_flash;
  cudaError_t err = cudaSuccess;
  int i = 0;
%s
  return err;
}
'''

_OCCUPANCY_CALL = '''  {
    auto kernel = %s;
    const int smem = static_cast<int>(%s);
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (!err) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + i++, kernel, kWG, smem);
  }'''


def _instrumented_source(stem):
    src = open(SOURCES[stem]).read()
    # the counters live outside the anonymous namespace so the C API can name them
    decl = "namespace bjx_flash {\nnamespace {\n"
    src = src.replace(decl, "namespace bjx_flash {\n__device__ unsigned long long "
                      "g_phases[2][8];\nnamespace {\n", 1)
    for kernel, (source, _, edits) in _PHASES.items():
        if source != stem:
            continue
        start = src.index(f"{kernel}(")
        end = src.index("\n}\n", start)
        body = src[start:end + 3]
        for old, new in edits:
            if body.count(old) != 1:
                raise SystemExit(f"flash_bwd_probe: {kernel} no longer has {old!r}")
            body = body.replace(old, new)
        src = src[:start] + body + src[end + 3:]
    calls = "\n".join(_OCCUPANCY_CALL % k for k in _OCCUPANCY[stem])
    return src + _PHASE_API % calls


def _build_instrumented(stem):
    path = os.path.join(OUT, f"flash_{stem}_tc_phases.cu")
    with open(path, "w") as f:
        f.write(_instrumented_source(stem))
    lib_path = os.path.join(OUT, f"libphases_{stem}.so")
    r = subprocess.run(NVCC + ["-shared", "-Xcompiler", "-fPIC", "-I" + CSRC, path,
                               "-o", lib_path], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"flash_bwd_probe: the instrumented {stem} build failed\n"
                         + r.stderr[-3000:])
    lib = ctypes.CDLL(lib_path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    shape = [i, i, i, i, i, i, f, i, i, i, i, i, p]
    if stem == "fwd":
        lib.bjx_flash_fwd_tc.argtypes = [p] * 5 + shape
    else:
        lib.bjx_flash_dq_tc.argtypes = [p] * 7 + shape
        lib.bjx_flash_dkv_tc.argtypes = [p] * 8 + shape
    blocks = (ctypes.c_int * len(_OCCUPANCY[stem]))()
    if lib.bjx_blocks_per_sm(blocks):
        raise SystemExit("flash_bwd_probe: occupancy query failed")
    print("blocks per SM at head dim 128: " + ", ".join(
        f"{k.split('<')[0]} {n}" for (k, _), n in zip(_OCCUPANCY[stem], blocks)))
    return lib


def phases():
    import torch

    from blendjax_torch.ops import flash_attention as flash

    os.makedirs(OUT, exist_ok=True)
    libs = {stem: _build_instrumented(stem) for stem in SOURCES}
    print(f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")

    b, t, h, d = 8, 512, 8, 128  # chip_smoke.FLASH_SHAPE
    g = torch.Generator(device="cuda").manual_seed(1)
    qf, kf, vf, dof = (torch.randn((b * h, t, d), generator=g, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
    scale = 1 / math.sqrt(d)
    of, lse = flash.flash_fwd_cuda(qf, kf, vf, True, scale)
    lse = lse.reshape(b * h, t).contiguous()
    delta = (dof.float() * of.float()).sum(-1).contiguous()
    o, lse_o, dq, dk, dv = (torch.empty_like(x) for x in (qf, lse, qf, qf, qf))
    problem = [b * h, h, h, t, t, d, scale, 1, 0, 0, 1, 1,
               torch.cuda.current_stream().cuda_stream]
    ins = [x.data_ptr() for x in (qf, kf, vf, dof, lse, delta)]
    # each kernel's launch, its outputs, and the port's library's on the same inputs
    runs = {
        "flash_fwd_tc_kernel": (lambda lib: lib.bjx_flash_fwd_tc(
            *ins[:3], o.data_ptr(), lse_o.data_ptr(), *problem), (o, lse_o), (of, lse)),
        "flash_dq_tc_kernel": (lambda lib: lib.bjx_flash_dq_tc(*ins, dq.data_ptr(), *problem),
                               (dq,), (flash.flash_dq_cuda(qf, kf, vf, dof, lse, delta, True,
                                                           scale),)),
        "flash_dkv_tc_kernel": (lambda lib: lib.bjx_flash_dkv_tc(
            *ins, dk.data_ptr(), dv.data_ptr(), *problem), (dk, dv),
            flash.flash_dkv_cuda(qf, kf, vf, dof, lse, delta, True, scale)),
    }
    for kernel, (stem, names, _) in _PHASES.items():
        lib = libs[stem]
        launch, got, want = runs[kernel]
        row_of = [k for k, v in _PHASES.items() if v[0] == stem].index(kernel)
        lib.bjx_phases_reset()
        if launch(lib):
            raise SystemExit(f"flash_bwd_probe: {kernel} launch failed")
        torch.cuda.synchronize()
        counts = (ctypes.c_ulonglong * 16)()
        lib.bjx_phases_read(counts)
        row = list(counts)[8 * row_of:8 * row_of + 8]
        iters, total = row[7], sum(row[:7])
        print(f"{kernel}: {iters} tile iterations, {total / iters:.1f} cycles each")
        for name, v in zip(names, row[:len(names)]):
            print(f"   {name:22s} {v / iters:8.1f} cycles  {100 * v / total:5.1f}%")
        if not all(torch.equal(a, w) for a, w in zip(got, want)):
            raise SystemExit(f"flash_bwd_probe: the instrumented {kernel} differs")
        print("   bit-equal to the port's library")


def ab(other):
    import torch

    import chip_smoke as cs
    from blendjax_torch.ops import flash_attention as flash

    os.makedirs(OUT, exist_ok=True)
    so = os.path.join(OUT, "libother_fwd.so")
    r = subprocess.run(NVCC + ["-shared", "-Xcompiler", "-fPIC", "-I" + CSRC, other, "-o", so],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"flash_bwd_probe: the build of {other} failed\n" + r.stderr[-3000:])
    lib = ctypes.CDLL(so)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bjx_flash_fwd_tc.argtypes = [p] * 5 + [i, i, i, i, i, i, f, i, i, i, i, i, p]
    b, t, h, d = cs.FLASH_SHAPE
    g = torch.Generator(device="cuda").manual_seed(1)
    qf, kf, vf, _ = cs._flash_inputs(torch, g, cs.FLASH_SHAPE, h, t, "bfloat16")
    scale = 1 / math.sqrt(d)
    o, lse = torch.empty_like(qf), torch.empty((b * h, t, 1), device="cuda")

    def other_fwd():
        if lib.bjx_flash_fwd_tc(qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), o.data_ptr(),
                                lse.data_ptr(), b * h, h, h, t, t, d, scale, 1, 0, 0, 1, 1,
                                torch.cuda.current_stream().cuda_stream):
            raise SystemExit(f"flash_bwd_probe: the forward of {other} did not launch")

    def port_fwd():
        return flash.flash_fwd_cuda(qf, kf, vf, True, scale)

    other_fwd()
    port_o, port_lse = port_fwd()
    torch.cuda.synchronize()
    print(f"bit-equal to the port's forward: O {torch.equal(o, port_o)}, "
          f"lse {torch.equal(lse, port_lse)}")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    times = {"port": [], "other": []}
    for name in ("port", "other", "other", "port", "port", "other"):
        fn = port_fwd if name == "port" else other_fwd
        times[name].append(cs.time_ms(torch, fn, reps=30, flush=flush) * 1e3)
    print(f"flagship forward, us in turns: {times}")


def _nvcc_report(source, obj):
    """Compiles ``source`` with ``-Xptxas -v`` and prints each kernel
    instance's registers, spill and shared memory; a failed build exits."""
    r = subprocess.run(NVCC + ["-Xptxas", "-v", "-I" + CSRC] + obj + [source],
                       capture_output=True, text=True)
    kernel = None
    for line in (r.stdout + r.stderr).splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "spill" in line or "Used" in line or "error" in line or "warning" in line:
            print(kernel, line.strip())
    if r.returncode:
        raise SystemExit(f"flash_bwd_probe: nvcc exited {r.returncode} on {source}")


def _decode_fn(lib):
    from blendjax_torch.ops import image

    fn = lib.bjx_decode_u8
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.POINTER(image.DecodePlan), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _decode_with(torch, fn, x, dtype, linearize=False, **plan_kw):
    """``fn`` (a form of ``bjx_decode_u8``) on ``x`` under the port's plan
    for these buffers, or the plan ``plan_kw`` asks for."""
    from blendjax_torch.ops import image

    out = torch.empty(x.shape, dtype=dtype, device="cuda")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = image.decode_plan(x.numel(), x.data_ptr(), out.data_ptr(), dtype, sms, **plan_kw)
    err = fn(x.data_ptr(), out.data_ptr(), x.numel(), 0 if dtype == torch.float32 else 1,
             int(linearize), ctypes.byref(plan), torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"flash_bwd_probe: decode launch failed: cudaError_t {err}")
    return out


def _bits(torch, t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def decode():
    import torch

    import chip_smoke as cs
    from blendjax_torch.ops import _build, image

    os.makedirs(OUT, exist_ok=True)
    _nvcc_report(os.path.join(CSRC, "decode.cu"), ["-c", "-o", os.path.join(OUT, "decode.o")])
    fn = _decode_fn(_build.load_library())
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(0, 256, cs.MAIN_SHAPE, dtype=torch.uint8, device="cuda", generator=g)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    n = x.numel()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    src = torch.empty(3 * n // 2, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)

    def copy():
        return dst.copy_(src)

    copy_ms = cs.time_ms(torch, copy, flush=flush, clean=True)
    floor_ms = cs.time_ms(torch, lambda: None, flush=flush, clean=True)
    print(f"copy_ of {src.numel()} bytes (moves {2 * src.numel()}): {copy_ms * 1e3:.2f} us "
          f"window, {cs.profiled_us(torch, copy, flush):.2f} us kernel, "
          f"{2 * src.numel() / copy_ms / 1e6:.1f} GB/s by the window; "
          f"window_floor_ms {floor_ms:.5f}", flush=True)
    configs = []
    for dtype in (torch.bfloat16, torch.float32):
        for chunk in (2048, 4096, 8192, 16384):
            for blocks_per_sm in (1, 2, 3, 4, 6, 8):
                try:
                    plan = image.decode_plan(n, 0, 0, dtype, sms, chunk=chunk,
                                             blocks_per_sm=blocks_per_sm)
                except ValueError:
                    continue  # too large for two stages
                configs.append((dtype, chunk, blocks_per_sm, plan))
    bad, window = 0, {}
    for turn in (configs, configs[::-1]):  # two turns, the second in reverse
        for dtype, chunk, blocks_per_sm, _ in turn:
            kw = dict(chunk=chunk, blocks_per_sm=blocks_per_sm)
            window.setdefault((dtype, chunk, blocks_per_sm), []).append(cs.time_ms(
                torch, lambda: _decode_with(torch, fn, x, dtype, **kw), flush=flush,
                clean=True) * 1e3)
    for dtype, chunk, blocks_per_sm, plan in configs:
        kw = dict(chunk=chunk, blocks_per_sm=blocks_per_sm)
        want = _bits(torch, image.decode_frames_plain(x, dtype))
        same = torch.equal(_bits(torch, _decode_with(torch, fn, x, dtype, **kw)), want)
        bad += not same
        kernel = cs.profiled_us(torch, lambda: _decode_with(torch, fn, x, dtype, **kw), flush)
        w = window[(dtype, chunk, blocks_per_sm)]
        print(f"decode {str(dtype)[6:]} chunk {chunk} blocks/SM {blocks_per_sm}: window "
              f"{w[0]:.2f} / {w[1]:.2f} us, kernel {kernel:.2f} us; grid {plan.grid}, "
              f"stages {plan.stages}, smem {plan.smem}, bit-equal {same}", flush=True)
    # the unaligned path: the main shape's flat buffer from byte 1, port's plan
    x1 = x.reshape(-1)[1:]
    for dtype in (torch.bfloat16, torch.float32):
        def unaligned():
            return image.decode_frames_cuda(x1, dtype)

        print(f"decode {str(dtype)[6:]} from byte 1 ({x1.numel()} elements): window "
              f"{cs.time_ms(torch, unaligned, flush=flush, clean=True) * 1e3:.2f} us, "
              f"kernel {cs.profiled_us(torch, unaligned, flush):.2f} us", flush=True)
    if bad:
        raise SystemExit(f"flash_bwd_probe: decode differs from the plain decode in {bad} plans")


def decode_ab(other):
    import torch

    import chip_smoke as cs
    from blendjax_torch.ops import image

    os.makedirs(OUT, exist_ok=True)
    so = os.path.join(OUT, "libother_decode.so")
    _nvcc_report(other, ["-shared", "-Xcompiler", "-fPIC", "-o", so])
    other_fn = _decode_fn(ctypes.CDLL(so))
    g = torch.Generator(device="cuda").manual_seed(0)
    bad = 0
    cases = cs.decode_cases(torch, image, g)
    for label, inp in cases:
        for dtype in (torch.float32, torch.bfloat16):
            for linearize in (False, True):
                a = image.decode_frames_cuda(inp, dtype, linearize)
                b = _decode_with(torch, other_fn, inp, dtype, linearize)
                if not torch.equal(_bits(torch, a), _bits(torch, b)):
                    bad += 1
                    print(f"DIFFERS {label} {dtype} linearize={linearize}")
    print(f"bit-equal to the port's decode on {4 * len(cases) - bad} of {4 * len(cases)} "
          "cases", flush=True)
    x = cases[0][1]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    times = {"port": [], "other": []}
    for name in ("port", "other", "other", "port", "port", "other"):
        if name == "port":
            fn = lambda: image.decode_frames_cuda(x, torch.bfloat16)  # noqa: E731
        else:
            fn = lambda: _decode_with(torch, other_fn, x, torch.bfloat16)  # noqa: E731
        times[name].append(cs.time_ms(torch, fn, flush=flush, clean=True) * 1e3)
    kernel = {name: cs.profiled_us(torch, fn, flush) for name, fn in (
        ("port", lambda: image.decode_frames_cuda(x, torch.bfloat16)),
        ("other", lambda: _decode_with(torch, other_fn, x, torch.bfloat16)))}
    print(f"decode {list(cs.MAIN_SHAPE)} -> bf16, us clean in turns: {times}; medians "
          f"port {sorted(times['port'])[1]:.2f}, other {sorted(times['other'])[1]:.2f}; "
          f"kernel (profiler) port {kernel['port']:.2f}, other {kernel['other']:.2f}")
    if bad:
        raise SystemExit(f"flash_bwd_probe: {other} differs on {bad} cases")


def main(argv):
    steps = {"ptxas": ptxas, "check": check, "phases": phases, "decode": decode}
    others = [a[3:] for a in argv if a.startswith("ab=")]
    decode_others = [a[10:] for a in argv if a.startswith("decode_ab=")]
    wanted = [a for a in argv if not a.startswith(("ab=", "decode_ab="))] or (
        [] if others or decode_others else list(steps))
    unknown = [a for a in wanted if a not in steps]
    if unknown:
        raise SystemExit(f"flash_bwd_probe: unknown step(s) {unknown}; choose from "
                         f"{list(steps)}, ab=SOURCE or decode_ab=SOURCE")
    if wanted != ["ptxas"]:
        import torch

        if not torch.cuda.is_available():
            print("flash_bwd_probe: CUDA is not available", file=sys.stderr)
            return 2
    sys.path.insert(0, REPO)
    for name in steps:
        if name in wanted:
            print(f"== {name}", flush=True)
            steps[name]()
    for other in others:
        print(f"== ab {other}", flush=True)
        ab(other)
    for other in decode_others:
        print(f"== decode_ab {other}", flush=True)
        decode_ab(other)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
