"""Time the wgmma stage-1 scan against edited copies of its own source, on one card.

    python3 hyperdb_tpu_torch/tools/gmax_variants.py [other_source.cu ...]

Builds ``hyperdb_tpu_torch/csrc/gmax_wgmma.cu`` as it stands and as a few
one-line edits that each take one thing away, plus any other source given
on the command line (a file with the same ``gmax_scan_wgmma`` entry point),
and times them all at the main path's shapes (2^20 x 384; bf16 at b = 512
and 16384 writing 32-row subgroup maxes, int8 at b = 1024 and 4096).
The edits:

- ``branchy``: the four k-steps of a box under a runtime count, as a ragged
  last box would have them. ptxas then fences between the wgmma
  (``C7520 ... serialized``), which is why the kernel runs all four always.
- ``same_group``: every corpus load reads the item's first group, so nearly
  all loads hit L2: what is left is not the corpus stream.
- ``no_epilogue``: nothing is stored, so the compiler drops the reduction:
  what is left is the product and its hand-overs.
- ``neither``: both of the above.

Results of the edits are wrong by design; only ``current`` and the files
given must agree with the first result, which the script checks. It then
times ``torch.mm`` (bf16) and ``torch._int_mm`` at 8192^3 as the card's
practical peak at its power limit, and samples clocks and power under load.
Needs one CUDA device and nvcc; prints the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from hyperdb_tpu_torch.ops import cuda_build  # noqa: E402
from hyperdb_tpu_torch.ops import gmax as G  # noqa: E402

N, D = 1 << 20, 384
STEPS = (
    "            wgmma_step(acc[0], da + 2 * ks, db + 2 * ks, (kb | ks) != 0);\n"
    "            wgmma_step(acc[1], da + 512 + 2 * ks, db + 2 * ks, (kb | ks) != 0);\n"
)
BRANCHY = (
    "            if (ks < (kb + 1 < kboxes ? 4 : (a.row_bytes - kb * BOX_BYTES + 31) / 32)) {\n"
    + STEPS + "            }\n"
)
LOAD = "tma_load(ring + s * TILE_BYTES, &vmap, full + 8 * s, kb * BOX_BYTES, g * GROUP);"
STORE_OK = "const bool ok = row < a.b;"


def edits(src: str) -> dict[str, str]:
    for needle in (STEPS, LOAD, STORE_OK):
        if needle not in src:
            raise SystemExit(f"gmax_wgmma.cu no longer holds the line this script edits: {needle!r}")
    same = src.replace(LOAD, LOAD.replace("g * GROUP", "g0 * GROUP"))
    never = "const bool ok = row < a.b && a.sub == 77;"  # no caller passes 77
    return {
        "current": src,
        "branchy": src.replace(STEPS, BRANCHY),
        "same_group": same,
        "no_epilogue": src.replace(STORE_OK, never),
        "neither": same.replace(STORE_OK, never),
    }


def build(sources: dict[str, str], out: Path) -> dict[str, ctypes.CDLL]:
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = out / f"{name}.cu"
        cu.write_text(text)
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log[-3000:]}")
        for line in log.splitlines():
            if "Used" in line or "spill" in line or "C75" in line:
                print(f"  [{name}] {line.strip()[:150]}")
        fn = ctypes.CDLL(str(out / f"lib{name}.so")).gmax_scan_wgmma
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def cuda_ms(fn, reps: int) -> float:
    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("gmax_variants: no CUDA device", file=sys.stderr)
        return 2
    card = smi("name,power.limit")
    sources = edits((cuda_build.CSRC / "gmax_wgmma.cu").read_text())
    exact = ["current"]
    for path in sys.argv[1:]:
        sources[Path(path).stem] = Path(path).read_text()
        exact.append(Path(path).stem)
    libs = build(sources, cuda_build.BUILD_DIR / "variants")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    v = torch.randn((N, D), device=dev, generator=gen).bfloat16()
    v8 = torch.randint(-127, 128, (N, D), device=dev, dtype=torch.int8, generator=gen)
    vs = torch.rand(N, device=dev, generator=gen)
    extra = torch.zeros(N, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for kind, b in ((G._KIND_F, 512), (G._KIND_F, 16384), (G._KIND_INT8, 1024), (G._KIND_INT8, 4096)):
        if kind == G._KIND_F:
            q = torch.randn((b, D), device=dev, generator=gen).bfloat16()
            qa, va, vv, sub = None, None, v, 32
            sm, gm = torch.empty((b, N // sub), device=dev), None
        else:
            q = torch.randint(-127, 128, (b, D), device=dev, dtype=torch.int8, generator=gen)
            qa, va, vv, sub = torch.rand(b, device=dev, generator=gen), vs, v8, 0
            sm, gm = None, torch.empty((b, N // 128), device=dev)
        out = sm if gm is None else gm
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        reps = 5 if b > 4096 else 10
        first = None
        for name, fn in libs.items():
            def run():
                rc = fn(kind, ptr(q), ptr(vv), ptr(qa), ptr(va), ptr(extra), ptr(sm), ptr(gm),
                        b, N, D, sub, stream)
                if rc:
                    raise RuntimeError(f"{name}: cudaError {rc}")
            ms = cuda_ms(run, reps)
            note = ""
            if name in exact:
                first = out.clone() if first is None else first
                note = f" equal to current: {torch.equal(out, first)}"
            print(f"kind={kind} b={b} {name}: {ms:.3f} ms {2.0 * b * N * D / ms / 1e9:.0f} T/s{note} "
                  f"[{card}]", flush=True)
        del sm, gm, out, first

    a = torch.randn((8192, 8192), device=dev, generator=gen).bfloat16()
    ms = cuda_ms(lambda: torch.mm(a, a.T), 10)
    print(f"torch.mm bf16 8192^3: {ms:.3f} ms {2 * 8192**3 / ms / 1e9:.0f} TFLOP/s [{card}]")
    if hasattr(torch, "_int_mm"):
        a8 = torch.randint(-127, 128, (8192, 8192), device=dev, dtype=torch.int8)
        ms = cuda_ms(lambda: torch._int_mm(a8, a8.T), 10)
        print(f"torch._int_mm 8192^3: {ms:.3f} ms {2 * 8192**3 / ms / 1e9:.0f} TOP/s [{card}]")

    # clocks and power while the kernel runs back to back
    q = torch.randn((16384, D), device=dev, generator=gen).bfloat16()
    sm = torch.empty((16384, N // 32), device=dev)
    stop = threading.Event()

    def sample():
        while not stop.is_set():
            print("  under load:", smi("clocks.sm,power.draw,temperature.gpu"), flush=True)
            time.sleep(0.4)

    thread = threading.Thread(target=sample)
    thread.start()
    t0 = time.time()
    while time.time() - t0 < 2.5:
        libs["current"](G._KIND_F, q.data_ptr(), v.data_ptr(), None, None, extra.data_ptr(),
                        sm.data_ptr(), None, 16384, N, D, 32, stream)
        torch.cuda.synchronize()
    stop.set()
    thread.join()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
