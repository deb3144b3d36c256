#!/usr/bin/env python3
"""Probe the tensor-core flash kernels (``blendjax_torch/ops/csrc/
flash_fwd_tc.cu``, the forward, and ``flash_bwd_tc.cu``, dQ and dK/dV) on
one NVIDIA GPU: what the compiler gave each kernel, whether every bf16 case
agrees with the plain passes at both output dtypes, the flagship timings,
and where a forward, dQ or dK/dV tile's cycles go.

    python3 flash_bwd_probe.py                  # ptxas, check, phases
    python3 flash_bwd_probe.py ptxas phases     # any subset, in that order
    python3 flash_bwd_probe.py ab=OTHER.cu      # another forward against the port's

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
ab     — another form of ``flash_fwd_tc.cu`` (any path, with the same C
         entry point) built beside the port's library: whether the two
         forwards agree bit for bit at the flagship shape, and their times
         there in turns (port, other, other, port, port, other) with
         ``chip_smoke.time_ms``, so that two designs are compared in one
         call on one card.

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
        r = subprocess.run(NVCC + ["-Xptxas", "-v", "-c", source,
                                   "-o", os.path.join(OUT, f"{stem}.o")],
                           capture_output=True, text=True)
        kernel = None
        for line in (r.stdout + r.stderr).splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif "spill" in line or "Used" in line or "error" in line or "warning" in line:
                print(kernel, line.strip())
        if r.returncode:
            raise SystemExit(f"flash_bwd_probe: nvcc exited {r.returncode} on {source}")


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


def main(argv):
    steps = {"ptxas": ptxas, "check": check, "phases": phases}
    others = [a[3:] for a in argv if a.startswith("ab=")]
    wanted = [a for a in argv if not a.startswith("ab=")] or ([] if others else list(steps))
    unknown = [a for a in wanted if a not in steps]
    if unknown:
        raise SystemExit(f"flash_bwd_probe: unknown step(s) {unknown}; choose from "
                         f"{list(steps)} or ab=SOURCE")
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
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
