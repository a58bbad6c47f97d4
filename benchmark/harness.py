"""Runs one cell of ``BENCHMARK.json`` once.

Set-up draws the configuration's corpus from the seed on the device,
ranks its terms, opens or builds the index through the program
(``program.py``) and lets the mix's driver prepare and warm up; it ends
with the device idle. The window then runs the driver's requests back to
back (a closed loop of one client) for ``seconds``: every request that
starts inside it is finished and counted, so the window ends with the last
one. With ``trace`` the profiler records a slice of it. Afterwards the
metrics' readers (``end_to_end/<name>.py``, or with ``trace``
``layer_metrics/<name>.py``) read what the window left, the program's
state is freed, and the configuration's reference (``references/``) judges
the driver's answers (``checks.py``).
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import resource
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark import checks, program
from benchmark import corpus as C
from benchmark import trace as T
from benchmark.traffic import band_terms

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "iresearch_tpu"}


def load_module(kind: str, name: str, root: Path = ROOT):
    """The module ``benchmark/<kind>/<name>.py`` of the checkout at
    ``root`` (names may hold dots)."""
    path = root / "benchmark" / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path} (named in BENCHMARK.json or a mix)")
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


class Cell:
    """A cell of the spec with its configuration file and mix file read."""

    def __init__(self, spec: dict, workload: str, root: Path = ROOT) -> None:
        cells = {w["name"]: w for w in spec["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.cell = cells[workload]
        entry = {c["name"]: c for c in spec["configs"]}[self.cell["config"]]
        self.config = json.loads((root / entry["file"]).read_text())
        self.config.setdefault("name", entry["name"])
        self.mix = json.loads(
            (root / "benchmark" / "traffic" / f"{self.cell['traffic']}.json").read_text())
        self.end_to_end = [m for m in spec["end_to_end"] if applies(m, workload)]
        self.per_layer = [m for m in spec["per_layer"] if applies(m, workload)]


class Context:
    """What a driver and a metric's reader see: the cell, the index, the
    spans and, after the window, what it left."""

    def __init__(self, cell: Cell, seed: int, device: torch.device, log) -> None:
        self.cell, self.config, self.mix = cell.cell, cell.config, cell.mix
        self.seed, self.device, self.log = seed, device, log
        self.k = int(self.config["top_k"])
        self.segments = None
        self.bands = None
        self.objects: Dict[str, object] = {}  # what a driver shows its readers
        self.spans: Dict[str, List[float]] = {}  # span name -> seconds of each
        self.profiler: Optional[T.Profiler] = None
        self.setup_s = self.window_s = 0.0
        self.latencies: List[float] = []
        self.queries = 0
        self.trace: Optional[T.Slice] = None

    @contextlib.contextmanager
    def span(self, name: str):
        """Time the block under ``name``; inside the traced slice the
        profiler notes it too, to name the device's idle gaps."""
        t = time.perf_counter()
        yield
        end = time.perf_counter()
        self.spans.setdefault(name, []).append(end - t)
        if self.profiler is not None and self.profiler.on:
            self.profiler.span(name, t, end)

    def fetch(self, tensors) -> Tuple[np.ndarray, list]:
        """The tensors' bytes on the host, as one client takes a request's
        results: concatenated on the device, copied in one piece into
        pinned memory, one wait. Returns (the bytes, their layout), which
        ``unpack`` turns into arrays."""
        flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in tensors])
        layout = [(t.dtype, tuple(t.shape)) for t in tensors]
        if self.device.type != "cuda":
            return flat.numpy().copy(), layout
        host = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return host.numpy().copy(), layout


def unpack(flat: np.ndarray, layout) -> List[np.ndarray]:
    """The arrays of a ``Context.fetch``."""
    out, off = [], 0
    for dtype, shape in layout:
        a = np.frombuffer(flat, torch.empty(0, dtype=dtype).numpy().dtype,
                          int(np.prod(shape, dtype=np.int64)), off).reshape(shape)
        out.append(a)
        off += a.nbytes
    return out


class Quarters:
    """What the host did in each quarter of the window, for the log: the
    interpreter's garbage collections by generation and their seconds,
    the process's CPU seconds and its involuntary context switches (the
    times the system took the core away from it)."""

    def __init__(self, w0: float, seconds: float) -> None:
        self.w0, self.seconds = w0, seconds
        self.gc = [[0, 0, 0, 0.0] for _ in range(4)]
        self.cpu: List[Tuple[float, int]] = [self._usage()]
        self._t = 0.0
        gc.callbacks.append(self._note)

    @staticmethod
    def _usage() -> Tuple[float, int]:
        ru = resource.getrusage(resource.RUSAGE_SELF)
        return ru.ru_utime + ru.ru_stime, ru.ru_nivcsw

    def _quarter(self, t: float) -> int:
        return min(3, max(0, int(4 * (t - self.w0) / self.seconds)))

    def _note(self, phase, info) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            q = self.gc[self._quarter(self._t)]
            q[info["generation"]] += 1
            q[3] += time.perf_counter() - self._t

    def tick(self, now: float) -> None:
        """Call between requests: notes the usage at each quarter's end."""
        if len(self.cpu) < 4 and now - self.w0 >= len(self.cpu) * self.seconds / 4:
            self.cpu.append(self._usage())

    def close(self) -> List[str]:
        gc.callbacks.remove(self._note)
        while len(self.cpu) < 5:
            self.cpu.append(self._usage())
        out = []
        for i in range(4):
            (c0, v0), (c1, v1) = self.cpu[i], self.cpu[i + 1]
            g = self.gc[i]
            out.append(f"q{i + 1}: gc {g[0]}/{g[1]}/{g[2]} in {g[3]:.4f} s, "
                       f"cpu {c1 - c0:.3f} s, involuntary switches {v1 - v0}")
        return out


def power_limit(device: torch.device) -> Optional[float]:
    """The card's power limit in W (``nvidia-smi``), None where unread."""
    if device.type != "cuda":
        return None
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30,
        )
        return float(r.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(spec: dict, workload: str, seed: int, seconds: float, trace: bool,
             device, t0: float, log, root: Path = ROOT) -> Tuple[Optional[dict], List[str]]:
    """(the result's line, the compared numbers beside their limits) of one
    run; (None, []) where a forbidden module was loaded."""
    cell = Cell(spec, workload, root)
    cfg, mix = cell.config, cell.mix
    device = torch.device(device)
    cuda = device.type == "cuda"
    driver = load_module("drivers", mix["driver"], root)
    metrics_of = cell.per_layer if trace else cell.end_to_end
    readers = {m["name"]: load_module("layer_metrics" if trace else "end_to_end", m["name"], root)
               for m in metrics_of}
    reference = load_module("references", cfg["reference"], root)
    ctx = Context(cell, seed, device, log)

    times: Dict[str, float] = {}
    t = time.perf_counter()
    corpus = C.generate(cfg["corpus"], cfg["segments"], seed, device)
    sync(device)
    times["corpus_s"] = time.perf_counter() - t
    t = time.perf_counter()
    ctx.bands = band_terms(mix, C.ranked_terms(C.doc_freqs(corpus)))
    times["ranks_s"] = time.perf_counter() - t
    ctx.segments, opened = program.open_index(
        root / ".bench_cache" / "benchmark" / cfg["name"], corpus, seed, device, log)
    times.update(opened)
    del corpus
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    state = driver.setup(ctx)
    sync(device)
    times["warmup_s"] = time.perf_counter() - t
    if trace:
        T.warm_profiler(lambda: (torch.ones(1, device=device) + 1, sync(device)), device)
        ctx.profiler = T.Profiler(device)
    gc.collect()
    gc.freeze()  # set-up's objects stay out of the window's collections
    sync(device)
    ctx.setup_s = time.perf_counter() - t0
    log(f"set-up {ctx.setup_s:.3f} s: " + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    log(f"caches before the window: {program.cache_sizes()}")

    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    ctx.spans = {}
    records, lat, ends, failed, nq = [], [], [], 0, 0
    lead, slice_s, started, traced = 0.25 * seconds, float(mix["trace_slice_s"]), None, []
    w0 = time.perf_counter()
    quarters = Quarters(w0, seconds)
    while True:
        now = time.perf_counter()
        quarters.tick(now)
        if now - w0 >= seconds:
            break
        prof = ctx.profiler
        if prof is not None:
            if started is None and now - w0 >= lead:
                prof.start()
                started = len(lat)
            elif prof.on and now - prof.t0 >= slice_s:
                prof.stop(len(lat) - started)
                traced = lat[started:]
        payload = driver.next_payload(state, ctx)
        t = time.perf_counter()
        try:
            rec, n = driver.request(state, ctx, payload)
        except Exception:  # a failed request is counted; the window goes on
            failed += 1
            if failed <= 3:
                log(traceback.format_exc())
            rec, n = None, 0
        lat.append(time.perf_counter() - t)
        ends.append((time.perf_counter() - w0, n))
        records.append(rec)
        nq += n
    ctx.window_s = time.perf_counter() - w0
    host = quarters.close()
    gc.unfreeze()
    if ctx.profiler is not None and ctx.profiler.on:
        ctx.profiler.stop(len(lat) - started)
        traced = lat[started:]
    ctx.latencies, ctx.queries = lat, nq
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    log(f"device memory peak: {setup_peak} bytes in set-up, {peak} in the window "
        "(the window's is the result's)")
    log(f"window {ctx.window_s:.3f} s: {len(lat)} requests, {nq} queries, {failed} failed")
    quarter = ctx.window_s / 4
    log("queries/s in each quarter of the window: " + ", ".join(
        f"{sum(n for e, n in ends if i * quarter < e <= (i + 1) * quarter) / quarter:.1f}"
        for i in range(4)))
    for line in host:
        log(f"host in the window's {line}")
    if traced:
        rest = lat[:started] + lat[started + len(traced):]
        log(f"traced slice: {len(traced)} requests, mean {1e3 * np.mean(traced):.4f} ms; "
            f"the window's others: mean {1e3 * np.mean(rest) if rest else float('nan'):.4f} ms")
    log(f"caches after the window: {program.cache_sizes()}")
    if ctx.profiler is not None:
        ctx.trace = ctx.profiler.read()
        ctx.profiler = None

    metrics = {}
    for m in metrics_of:
        v = readers[m["name"]].read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    answers = driver.answers(state, records, ctx)
    del state, records
    ctx.segments = None
    ctx.objects.clear()
    program.release()
    gc.collect()

    t = time.perf_counter()
    corpus = C.generate(cfg["corpus"], cfg["segments"], seed, device)
    numbers = checks.judge(answers, reference.make(corpus, cfg), ctx.k)
    log(f"reference: {numbers['answers']} answers judged in {time.perf_counter() - t:.3f} s")
    del corpus
    correct = failed == 0 and numbers["answers"] > 0 and checks.passed(numbers)

    found = sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)
    if found:
        log(f"forbidden modules loaded: {found}")
        return None, []
    dev = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else device.type,
        "count": int(cell.cell["chips"]),
        "memory_peak_bytes": int(peak),
        "power_limit_w": power_limit(device),
    }
    line = {"correct": bool(correct), "attempted": len(lat), "failed": failed,
            "metrics": metrics, "device": dev}
    if ctx.trace is not None:
        dev["busy_s"] = ctx.trace.busy_s()
        dev["window_s"] = ctx.trace.window_s
        line["breakdown"] = {"device_ops": ctx.trace.top_ops(10),
                             "idle_gaps": ctx.trace.idle_by_span(10)}
    line["checks"] = {name: {"value": numbers[name], "limit": limit}
                      for name, limit in checks.LIMITS.items()}
    return line, checks.lines(numbers)
