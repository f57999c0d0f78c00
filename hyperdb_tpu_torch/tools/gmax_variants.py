"""Time the wgmma stage-1 scan against edited copies of its own source, on one card.

    python3 hyperdb_tpu_torch/tools/gmax_variants.py [other_source.cu ...]

Builds ``hyperdb_tpu_torch/csrc/gmax_wgmma.cu`` as it stands and as a few
one-line edits that each take one thing away, plus any other source given
on the command line (a file with the same ``gmax_scan_wgmma`` entry point,
such as the file from an earlier tree), and times them at three sets of
shapes, each line beside the scan's least time on the card
(``tools/scan_bound.py``). Each shape times every build in five rounds that
take the builds in turn, each round starting one build further on (a build
timed first in a row reads a few per cent slow), and prints each build's
median over the rounds beside the fastest and slowest round:

- the main path's (2^20 x 384; bf16 at b = 512 and 16384 writing 32-row
  subgroup maxes, int8 at b = 1024 and 4096): every build;
- the 768-d benchmark cells' planes (2^23 and 2^21 rows, b = 1024 and 32):
  the current source, its two forms and the streaming entry point
  ``gmax_scan_wgmma_stream`` of the current source forced onto these rows
  (a yardstick: no route sends rows of 12 boxes there). An earlier tree's
  kernel is timed at these shapes by ``chip_smoke.py --before`` (path O's
  ``ms_before``), not here;
- a sweep of the depth from 2 to 12 boxes of 128 bytes (bf16 d = 128..768)
  over 2^21 rows at b = 32, 128, 256 and 1024, and int8 rows of 11 and 12
  boxes at b = 1024 and 32: the current source, its two forms and the files
  given.

The edits:

- ``pair_only`` / ``tile_only``: the entry point's rule (``pair_form``) made
  to pick the pair form, or the 128-query form, at every shape.
- ``branchy``: the four k-steps of a box under a runtime count, as a ragged
  last box would have them. ptxas then fences between the wgmma
  (``C7520 ... serialized``), which is why the kernel runs all four always.
- ``same_group``: every corpus load of a work reads its first item, so
  nearly all loads hit L2: what is left is not the corpus stream.
- ``no_epilogue``: nothing is stored, so the compiler drops the reduction:
  what is left is the product and its hand-overs.
- ``neither``: both of the above.

Results of the last four edits are wrong by design; ``current``, the two
forms, the files given and the streaming yardstick must agree with the first
result bit for bit, which the script checks. It then times ``torch.mm``
(bf16) and ``torch._int_mm`` at 8192^3 as the card's practical peak at its
power limit, and samples clocks and power under load. Needs one CUDA device
and nvcc; prints the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import statistics
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
from hyperdb_tpu_torch.tools.scan_bound import scan_bound_ms  # noqa: E402

N, D = 1 << 20, 384
CELL_ROWS = (1 << 23, 1 << 21)  # the Cohere cell's two planes of 768-d rows
CELL_BATCHES = (1024, 32)  # the batch cell's batch and a served flush
SWEEP_BATCHES = (32, 128, 256, 1024)
SWEEP_ROWS = 1 << 21
SWEEP_DEPTHS = tuple(64 * k for k in range(2, 13))  # bf16 rows of 2..12 boxes
INT8_DEPTHS = (1408, 1536)  # int8 rows of 11 and 12 boxes
ROUNDS = 5
STEPS = (
    "            if constexpr (PAIR) {\n"
    "              wgmma_step256(reinterpret_cast<Acc(&)[128]>(acc), da + 2 * ks, db + 2 * ks,\n"
    "                            (kb | ks) != 0);\n"
    "            } else {\n"
    "              wgmma_step(acc[0], da + 2 * ks, db + 2 * ks, (kb | ks) != 0);\n"
    "              wgmma_step(acc[1], da + 512 + 2 * ks, db + 2 * ks, (kb | ks) != 0);\n"
    "            }\n"
)
BRANCHY = (
    "            if (ks < (kb + 1 < kboxes ? 4 : (a.row_bytes - kb * BOX_BYTES + 31) / 32)) {\n"
    + STEPS + "            }\n"
)
LOADS = ("c * F::ITEM + h * GROUP);", "c * F::ITEM + rank * GROUP,")
STORE_OK = "const bool ok = row < a.b;"
RULE = "bool pair_form(int kboxes) { return kboxes >= PAIR_MIN_KBOXES; }"


def edits(src: str) -> dict[str, str]:
    for needle in (STEPS, *LOADS, STORE_OK, RULE):
        if src.count(needle) != 1:
            raise SystemExit(f"gmax_wgmma.cu no longer holds the line this script edits: {needle!r}")
    same = src
    for load in LOADS:
        same = same.replace(load, load.replace("c * F::ITEM", "k.c0 * F::ITEM"))
    never = "const bool ok = row < a.b && a.sub == 77;"  # no caller passes 77
    return {
        "current": src,
        "pair_only": src.replace(RULE, RULE.replace("return kboxes", "return true || kboxes")),
        "tile_only": src.replace(RULE, RULE.replace("return kboxes", "return false && kboxes")),
        "branchy": src.replace(STEPS, BRANCHY),
        "same_group": same,
        "no_epilogue": src.replace(STORE_OK, never),
        "neither": same.replace(STORE_OK, never),
    }


def build(sources: dict[str, str], out: Path) -> dict[str, ctypes.CDLL]:
    """Compile each source into ``out``, all at once; print what ptxas says of
    registers, spills and serialised wgmma. Returns the loaded libraries."""
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
        kernel = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                mangled = line.split("'")[1]  # its template arguments: ILi<KIND>ELb<PAIR>E
                kernel = mangled[mangled.find("gmax_"):][:30]
            if "Used" in line or "spill" in line or "C75" in line:
                print(f"  [{name}] {kernel}: {line.strip()[:150]}")
        libs[name] = ctypes.CDLL(str(out / f"lib{name}.so"))
    return libs


def entry(lib: ctypes.CDLL, name: str = "gmax_scan_wgmma"):
    """One of the library's two stage-1 entry points, with its argument types."""
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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


def rounds_ms(fns: dict, reps: int, rounds: int = ROUNDS) -> dict:
    """Each of ``fns`` (name -> callable) timed ``rounds`` times, the names
    taken in turn and each round starting one name further on; returns
    name -> the per-round medians of ``reps`` runs."""
    names = list(fns)
    times = {name: [] for name in names}
    for r in range(rounds):
        for name in names[r % len(names):] + names[: r % len(names)]:
            times[name].append(cuda_ms(fns[name], reps))
    return times


def time_shape(fns, kind, b, n, d, v, card, exact, gen) -> None:
    """Time each of ``fns`` (name -> entry point) at one shape in
    ``rounds_ms``'s rounds; the names in ``exact`` must write what the first
    of them wrote, bit for bit."""
    dev = v.device
    if kind == G._KIND_F:
        q = torch.randn((b, d), device=dev, generator=gen).bfloat16()
        qa = va = gm = None
        sub = 32
        sm = torch.empty((b, n // sub), device=dev)
    else:
        q = torch.randint(-127, 128, (b, d), device=dev, dtype=torch.int8, generator=gen)
        qa, va = torch.rand(b, device=dev, generator=gen), torch.rand(n, device=dev)
        sub, sm = 0, None
        gm = torch.empty((b, n // 128), device=dev)
    extra = torch.zeros(n, device=dev)
    out = sm if gm is None else gm
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream().cuda_stream
    reps = 5 if 2.0 * b * n * d > 1e13 else 10
    bound = scan_bound_ms(b, n, d, n // (sub or 128), "bf16" if kind == G._KIND_F else "int8")[0]
    first = None
    runs, notes = {}, {}
    for name, fn in fns.items():
        def run(fn=fn, name=name):
            rc = fn(kind, ptr(q), ptr(v), ptr(qa), ptr(va), ptr(extra), ptr(sm), ptr(gm),
                    b, n, d, sub, stream)
            if rc:
                raise RuntimeError(f"{name}: cudaError {rc}")
        run()
        torch.cuda.synchronize()
        notes[name] = ""
        if name in exact:
            first = out.clone() if first is None else first
            notes[name] = f" equal to {exact[0]}: {torch.equal(out, first)}"
        runs[name] = run
    for name, times in rounds_ms(runs, reps).items():
        ms = statistics.median(times)
        print(f"kind={kind} b={b} n={n} d={d} {name}: {ms:.4f} ms "
              f"(rounds {min(times):.4f}-{max(times):.4f}) "
              f"{2.0 * b * n * d / ms / 1e9:.0f} T/s bound_ms={bound:.4f} "
              f"bound/ms={bound / ms:.3f}{notes[name]} [{card}]", flush=True)
    del q, sm, gm, out, first


def main() -> int:
    if not torch.cuda.is_available():
        print("gmax_variants: no CUDA device", file=sys.stderr)
        return 2
    card = smi("name,power.limit")
    sources = edits((cuda_build.CSRC / "gmax_wgmma.cu").read_text())
    given = [Path(path).stem for path in sys.argv[1:]]
    for path in sys.argv[1:]:
        sources[Path(path).stem] = Path(path).read_text()
    libs = build(sources, cuda_build.BUILD_DIR / "variants")
    every = {name: entry(lib) for name, lib in libs.items()}
    compared = {name: every[name] for name in ("current", "pair_only", "tile_only", *given)}
    exact = list(compared)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    v = torch.randn((N, D), device=dev, generator=gen).bfloat16()
    v8 = torch.randint(-127, 128, (N, D), device=dev, dtype=torch.int8, generator=gen)
    for kind, b in ((G._KIND_F, 512), (G._KIND_F, 16384), (G._KIND_INT8, 1024), (G._KIND_INT8, 4096)):
        time_shape(every, kind, b, N, D, v if kind == G._KIND_F else v8, card, exact, gen)
    del v8

    # the 768-d cells' planes, with the streaming kernel forced onto them
    forms = ("current", "pair_only", "tile_only")
    stream = {**{name: every[name] for name in forms},
              "wgmma_stream": entry(libs["current"], "gmax_scan_wgmma_stream")}
    for n in CELL_ROWS:
        v = torch.randn((n, 768), device=dev, generator=gen).bfloat16()
        for b in CELL_BATCHES:
            time_shape(stream, G._KIND_F, b, n, 768, v, card, list(stream), gen)
        del v
        torch.cuda.empty_cache()

    # the depth sweep, and int8 rows of 11 and 12 boxes
    for d in INT8_DEPTHS:
        v8 = torch.randint(-127, 128, (SWEEP_ROWS, d), device=dev, dtype=torch.int8, generator=gen)
        for b in CELL_BATCHES:
            time_shape(compared, G._KIND_INT8, b, SWEEP_ROWS, d, v8, card, exact, gen)
        del v8
    for d in SWEEP_DEPTHS:
        v = torch.randn((SWEEP_ROWS, d), device=dev, generator=gen).bfloat16()
        for b in SWEEP_BATCHES:
            time_shape(compared, G._KIND_F, b, SWEEP_ROWS, d, v, card, exact, gen)
        del v
    torch.cuda.empty_cache()

    a = torch.randn((8192, 8192), device=dev, generator=gen).bfloat16()
    ms = cuda_ms(lambda: torch.mm(a, a.T), 10)
    print(f"torch.mm bf16 8192^3: {ms:.3f} ms {2 * 8192**3 / ms / 1e9:.0f} TFLOP/s [{card}]")
    if hasattr(torch, "_int_mm"):
        a8 = torch.randint(-127, 128, (8192, 8192), device=dev, dtype=torch.int8)
        ms = cuda_ms(lambda: torch._int_mm(a8, a8.T), 10)
        print(f"torch._int_mm 8192^3: {ms:.3f} ms {2 * 8192**3 / ms / 1e9:.0f} TOP/s [{card}]")

    # clocks and power while the kernel runs back to back
    v = torch.randn((N, D), device=dev, generator=gen).bfloat16()
    q = torch.randn((16384, D), device=dev, generator=gen).bfloat16()
    sm = torch.empty((16384, N // 32), device=dev)
    extra = torch.zeros(N, device=dev)
    stream_ptr = torch.cuda.current_stream().cuda_stream
    stop = threading.Event()

    def sample():
        while not stop.is_set():
            print("  under load:", smi("clocks.sm,power.draw,temperature.gpu"), flush=True)
            time.sleep(0.4)

    thread = threading.Thread(target=sample)
    thread.start()
    t0 = time.time()
    while time.time() - t0 < 2.5:
        every["current"](G._KIND_F, q.data_ptr(), v.data_ptr(), None, None, extra.data_ptr(),
                         sm.data_ptr(), None, 16384, N, D, 32, stream_ptr)
        torch.cuda.synchronize()
    stop.set()
    thread.join()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
