#!/usr/bin/env python3
"""Where the time goes inside K3's cluster kernel (csrc/fused_mlp_i8.cu).

    python3 tools/k3_phases.py [--local-slices]

Builds an instrumented copy of csrc/fused_mlp_i8.cu (with int8_gemm.cu, for
the LN2 row pass) into build/k3_phases/ with nvcc: one thread of each CTA
reads clock64() at the phase boundaries of every row block and sums the
cycles per phase. Runs the cluster kernel alone (the codes entry) at the
Swin-L K3 shapes and prints, per shape, the call's CUDA-event time and the
mean cycles per row block of each phase over the CTAs: fc1 (with its ring
waits), GELU (the dequant, the GELU, the row maxima and the warpgroups'
barrier), the row-amax exchange (the sends and the wait for every CTA of
the cluster), quantization (into the slice, and the barrier and arrivals
that publish it), the wait for every CTA's slice, fc2, and the epilogue.
Also prints the largest number of clusters the card runs at once
(cudaOccupancyMaxActiveClusters) at each C the Swin widths use.

--local-slices makes fc2 read the CTA's own slice for every k step instead
of the owners' (wrong results, timing only): the difference in fc2's
cycles is what reading the other CTAs' shared memory costs.

Needs one CUDA device and nvcc; exits 1 without them.
"""

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "birefnet_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "k3_phases")
PHASES = ["fc1", "gelu", "amax exchange", "quantize", "slices wait", "fc2",
          "epilogue"]
SHAPES = [(8192, 768), (2048, 768), (2048, 1536), (512, 1536)]


def instrumented(local_slices: bool) -> str:
    """The kernel's source with the phase counters."""
    src = open(os.path.join(CSRC, "fused_mlp_i8.cu")).read()

    def insert(anchor: str, code: str, before: bool = True) -> None:
        nonlocal src
        if src.count(anchor) != 1:
            raise SystemExit(f"k3_phases: anchor not found once: {anchor!r}")
        src = src.replace(anchor, code + anchor if before else anchor + code)

    src = src.replace('#include "int8.cuh"',
                      '#include "int8.cuh"\n__device__ long long* g_phases;', 1)
    tick = "      {{ long long t = clock64(); P[{}] += t - t0; t0 = t; }}\n"
    insert("\n    for (int rb = (int)cluster_index();",
           "\n    long long P[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
           "    long long t0 = clock64();")
    for k, anchor in enumerate((
            "      // ---- dequant + b1 + GELU in registers",
            "      // ---- this CTA's row maxima to every CTA of the cluster",
            "      // ---- per-token int8 of the whole 4C row",
            "      // ---- fc2 over K = 4C",
            "      load(fa0, 0);\n",
            "      // ---- the two half sums meet")):
        insert(anchor, tick.format(k))
    # After the row-block loop (closed by the brace after the last
    # finish), thread 0 writes its CTA's sums.
    insert("        finish(std::integral_constant<int, 1>{});\n    }\n",
           tick.format(6) + "      P[7] += 1;\n    }\n"
           "    if (threadIdx.x == 0)\n"
           "      for (int k = 0; k < 8; ++k) g_phases[blockIdx.x * 8 + k] = P[k];\n",
           before=False)
    src = src.replace("        finish(std::integral_constant<int, 1>{});\n    }\n" + tick.format(6),
                      "        finish(std::integral_constant<int, 1>{});\n" + tick.format(6), 1)
    if local_slices:
        old = "f[4 * u + kk] = ld_peer(peer(slice + off, owner));"
        if src.count(old) != 1:
            raise SystemExit("k3_phases: fragment load not found")
        src = src.replace(old, "f[4 * u + kk] = ld_peer(peer(slice + off, rank));")
    src = src.replace("namespace mlp8 {\nnamespace {", "namespace mlp8 {\ninline namespace phases {", 1)
    src += '''
extern "C" int k3_phases_buffer(void* buf) {
  return (int)cudaMemcpyToSymbol(g_phases, &buf, sizeof(void*));
}
extern "C" int k3_max_clusters(int C) {
  const auto kernel = bt::mlp8::fused_mlp_i8_kernel<bf16>;
  const int S = (C + bt::mlp8::kOut - 1) / bt::mlp8::kOut;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bt::mlp8::kSmem);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchAttribute a[1];
  a[0].id = cudaLaunchAttributeClusterDimension;
  a[0].val.clusterDim.x = S;
  a[0].val.clusterDim.y = 1;
  a[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(bt::mlp8::kThreads);
  cfg.dynamicSmemBytes = bt::mlp8::kSmem;
  cfg.attrs = a;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(S);
  int n = -1;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}
'''
    return src


def build(local_slices: bool) -> str:
    os.makedirs(OUT, exist_ok=True)
    tag = "local" if local_slices else "peers"
    cu = os.path.join(OUT, f"k3_{tag}.cu")
    with open(cu, "w") as f:
        f.write(instrumented(local_slices))
    nvcc = "/usr/local/cuda/bin/nvcc"
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", f"-I{CSRC}"]
    objs = [os.path.join(OUT, f"k3_{tag}.o"), os.path.join(OUT, "int8_gemm.o")]
    procs = [subprocess.Popen([nvcc, *flags, "-c", "-o", o, s]) for o, s in
             zip(objs, (cu, os.path.join(CSRC, "int8_gemm.cu")))]
    if any(p.wait() for p in procs):
        raise SystemExit("k3_phases: nvcc failed")
    lib = os.path.join(OUT, f"libk3_{tag}.so")
    subprocess.run([nvcc, *flags, "-shared", "-o", lib, *objs], check=True)
    return lib


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--local-slices", action="store_true")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from birefnet_tpu_torch import params as P
    from birefnet_tpu_torch.ops.kernels import int8_gemm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    lib = ctypes.CDLL(build(args.local_slices))
    lib.k3_max_clusters.argtypes = [ctypes.c_int]
    lib.k3_phases_buffer.argtypes = [ctypes.c_void_p]
    for c in (768, 1024, 1536):
        print(f"[k3_phases] C={c}: at most {lib.k3_max_clusters(c)} clusters of "
              f"{-(-c // 96)} CTAs at once ({smi})", flush=True)
    fn = lib.bt_fused_mlp_i8_codes
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    for t, c in SHAPES:
        x = torch.randn((t, c), generator=gen, device=dev).to(torch.bfloat16)
        ln = {"scale": 1 + 0.1 * torch.randn(c, generator=gen, device=dev),
              "bias": 0.1 * torch.randn(c, generator=gen, device=dev)}
        mlp32 = {n: {"weight": torch.randn((o, k), generator=gen, device=dev) * 0.05,
                     "bias": 0.1 * torch.randn(o, generator=gen, device=dev)}
                 for n, k, o in (("fc1", c, 4 * c), ("fc2", 4 * c, c))}
        mlp = P.quantize_mlp_int8({"mlp": mlp32}, 0)["mlp"]
        codes, scales = int8_gemm.quantize_rows(x, ln)
        out = torch.empty_like(x)
        counts = torch.zeros(132 * 8 * 2, dtype=torch.int64, device=dev)
        lib.k3_phases_buffer(counts.data_ptr())
        fc1, fc2 = mlp["fc1"], mlp["fc2"]
        argv = [codes.data_ptr(), scales.data_ptr(), x.data_ptr(),
                fc1["weight_q8"].data_ptr(), fc1["scale_q8"].data_ptr(),
                fc1["bias"].data_ptr(), fc2["weight_q8"].data_ptr(),
                fc2["scale_q8"].data_ptr(), fc2["bias"].data_ptr(),
                out.data_ptr(), t, c, torch.cuda.current_stream().cuda_stream]
        for _ in range(3):  # warm-up
            if fn(*argv) != 0:
                raise SystemExit("k3_phases: launch failed")
        counts.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*argv)
        end.record()
        torch.cuda.synchronize()
        rows = counts.view(-1, 8).cpu()
        rows = rows[rows[:, 7] > 0]
        per = (rows[:, :7].double() / rows[:, 7:8].double()).mean(0).tolist()
        print(f"[k3_phases] T={t} C={c}{' (own slice only)' if args.local_slices else ''}: "
              f"{start.elapsed_time(end) * 1e3:.1f} us, {rows.shape[0]} CTAs, "
              f"cycles per row block: "
              + ", ".join(f"{n} {v:.0f}" for n, v in zip(PHASES, per))
              + f" ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
