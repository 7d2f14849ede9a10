"""K1's time against the blocks of its partial kernel that share an SM.

Builds ``csrc/render_score.cu`` once per variant into a temporary
directory: as it is (its registers decide how many blocks share an SM),
and with each block's dynamic shared memory padded so that at most 5 or
4 blocks fit on one.  Each variant's resident blocks per SM come from
``cudaOccupancyMaxActiveBlocksPerMultiprocessor``.  All variants score
the tracker's evaluation (64 particles spawned around the true pose of
frame 0 of the default sequence, 48 spheres, frame 1's 16,384 pixels),
must agree bit for bit, and are timed by CUDA events over back-to-back
launches (partial and reduce kernel), in rounds that alternate their
order.

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    PYTHONPATH=src python3 -m repro_torch.bench.k1_occupancy
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from repro_torch.core import handmodel as hm
from repro_torch.core import tracker
from repro_torch.core.camera import BACKGROUND_DEPTH
from repro_torch.core.objective import CLAMP_T
from repro_torch.data import rgbd
from repro_torch.kernels import _build

SMEM_LINE = "const size_t smem = static_cast<size_t>(num_spheres) * sizeof(float4);"
SMEM_PER_SM = 228 * 1024  # Hopper: shared memory per SM at the largest carveout
SMEM_RESERVED_PER_BLOCK = 1024
ROUNDS, REPS = 6, 500  # rounds alternate the variants' order

PROBE = r"""
#ifndef PROBE_SMEM_PAD
#define PROBE_SMEM_PAD 0
#endif
// Prepares the partial kernel for a launch with num_spheres spheres and
// returns how many of its blocks fit on one SM.
extern "C" int probe_blocks_per_sm(int num_spheres) {
  const int smem = num_spheres * static_cast<int>(sizeof(float4)) + PROBE_SMEM_PAD;
  if (PROBE_SMEM_PAD > 0) {
    cudaFuncSetAttribute(render_score_partial_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaFuncSetAttribute(render_score_partial_kernel,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
  }
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, render_score_partial_kernel, kThreads, smem) != cudaSuccess) {
    return -1;
  }
  return blocks;
}
"""


def _pad_for(blocks: int, num_spheres: int) -> int:
    """Dynamic shared memory to add so that ``blocks``, and not one
    more, fit on an SM."""
    static = 32 * 4  # warp_sums, rounded up
    per_block = SMEM_PER_SM // blocks - SMEM_RESERVED_PER_BLOCK - static
    return per_block - num_spheres * 16 - 512  # margin under the limit


def _build_variant(work: Path, name: str, pad: int) -> ctypes.CDLL:
    src = (_build.CSRC_DIR / "render_score.cu").read_text()
    if SMEM_LINE not in src:
        raise RuntimeError("render_score.cu no longer sizes its shared memory as expected")
    src = src.replace(SMEM_LINE, SMEM_LINE[:-1] + " + PROBE_SMEM_PAD;") + PROBE
    cu = work / f"{name}.cu"
    cu.write_text(f"#define PROBE_SMEM_PAD {pad}\n" + src)
    so = work / f"{name}.so"
    out = subprocess.run(
        [_build.find_nvcc(), *_build.ARCH_FLAGS, *_build.COMPILE_FLAGS, "-shared",
         str(cu), "-o", str(so)], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{out.stdout}{out.stderr}")
    lines = (out.stdout + out.stderr).splitlines()
    entry = [i for i, line in enumerate(lines)
             if "Compiling entry" in line and "render_score_partial_kernel" in line]
    regs = [line.strip() for line in lines[entry[0]:] if "registers" in line] if entry else []
    print(f"[build] {name} (pad {pad} B), partial kernel: "
          f"{regs[0] if regs else 'no ptxas line'}")
    lib = ctypes.CDLL(str(so))
    lib.render_score_sums_launch.argtypes = _build._SIGNATURES["render_score_sums_launch"]
    lib.render_score_sums_launch.restype = ctypes.c_int
    lib.probe_blocks_per_sm.argtypes = [ctypes.c_int]
    lib.probe_blocks_per_sm.restype = ctypes.c_int
    return lib


def _inputs(device):
    seq, cfg = rgbd.SequenceConfig(num_frames=2), tracker.TrackerConfig()
    frames, truth = rgbd.render_sequence(seq, device=device)
    h_prev = truth[0]
    lo = hm.parameter_lower_bounds(h_prev, 0.10, 0.25)
    hi = hm.parameter_upper_bounds(h_prev, 0.10, 0.25)
    gen = torch.Generator(device=device).manual_seed(1)
    n = cfg.pso.num_particles
    hs = lo + torch.rand((n, 27), generator=gen, device=device) * (hi - lo)
    hs = hm.normalize_configuration(torch.cat([h_prev[None], hs[1:]]))
    depth = frames[1].reshape(-1)
    mask = (torch.abs(depth - h_prev[2]) < 0.25).to(torch.float32)
    return (hm.pack_spheres(hs).contiguous(), cfg.camera.rays_flat(device).contiguous(),
            depth.contiguous(), mask.contiguous())


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_occupancy: needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    spheres, rays, depth, mask = _inputs(device)
    n, s = spheres.shape[:2]
    p = rays.shape[0]
    stream = torch.cuda.current_stream(device).cuda_stream

    with tempfile.TemporaryDirectory(prefix="k1_occupancy-") as tmp:
        variants = {"as_is": 0, "pad_5": _pad_for(5, s), "pad_4": _pad_for(4, s)}
        libs = {name: _build_variant(Path(tmp), name, pad) for name, pad in variants.items()}
        occupancy = {name: lib.probe_blocks_per_sm(s) for name, lib in libs.items()}
        print(f"[occupancy] partial-kernel blocks per SM: {occupancy}")
        if occupancy["pad_5"] != 5 or occupancy["pad_4"] != 4:
            print("k1_occupancy: the padding did not set the occupancy it aimed at",
                  file=sys.stderr)
            return 1
        tiles = -(-p // libs["as_is"].render_score_tile_pixels())
        partial = torch.empty((n, tiles), dtype=torch.float32, device=device)

        def launcher(lib, out):
            def launch():
                err = lib.render_score_sums_launch(
                    spheres.data_ptr(), rays.data_ptr(), depth.data_ptr(), mask.data_ptr(),
                    partial.data_ptr(), out.data_ptr(), 1, n, s, p, CLAMP_T,
                    BACKGROUND_DEPTH, stream)
                if err:
                    raise RuntimeError(f"launch failed with CUDA error {err}")
            return launch

        outs = {name: torch.empty(n, dtype=torch.float32, device=device) for name in libs}
        launches = {name: launcher(lib, outs[name]) for name, lib in libs.items()}
        for launch in launches.values():
            launch()
        torch.cuda.synchronize()
        ref = outs["as_is"]
        for name, out in outs.items():
            if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
                print(f"k1_occupancy: {name} differs from as_is", file=sys.stderr)
                return 1

        times = {name: [] for name in libs}
        order = list(libs)
        for r in range(ROUNDS):
            for name in (order if r % 2 == 0 else order[::-1]):
                launch = launches[name]
                for _ in range(20):
                    launch()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(REPS):
                    launch()
                end.record()
                end.synchronize()
                times[name].append(start.elapsed_time(end) / REPS * 1e3)
        for name in libs:
            print(f"[time] {name}: {occupancy[name]} blocks/SM, median "
                  f"{statistics.median(times[name]):.2f} us per launch "
                  f"(rounds {' '.join(f'{t:.2f}' for t in times[name])})")
        print(json.dumps({"k1_occupancy": {
            name: {"blocks_per_sm": occupancy[name], "pad_bytes": variants[name],
                   "us_per_launch": times[name]} for name in libs},
            "shape": {"N": n, "S": s, "P": p, "tiles": tiles}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
