"""Run single phases of ``chip_smoke.py`` on one NVIDIA GPU (8 the single
query's breadth categories and tiers, fused and eager; 9 phrases; 12 the
sharded executor over the three-segment index, fused and eager; 14 the
CLI, 15 embedding training, 16 the multi-process dryrun, 17 the mesh of
devices over the three-segment index, 18 the benchmark entry points over
the first segment, 19 the NCCL mesh over the three-segment index after
phase 17, and over every visible card one process per card), and two
measurements behind their design:

* ``--gloo``: whether a ``gloo`` group's ``all_gather`` takes CUDA tensors
  (two processes on one card);
* ``--gather-forms``: one training step of ``analysis/embed.py``'s loss at
  phase 15's size (120,000 docs, [N, 1,805] row ids, dim 16) for each form
  of the rows' gather and its backward: ``F.embedding``, ``emb[R]``,
  ``index_select``, a CSR ``index_add`` over the real rows and
  ``embedding_bag``.

Usage, from the repo root on the card's machine::

    python3 scripts/torch_smoke_phases.py [--gloo] [--gather-forms] \\
        [--docs N] [--profile FILE] [--cli-docs N --cli-segment-docs M] [PHASE ...]

``eager`` times the eager sharded pass over phase 12's index with one
shard and with phase 17's four shards on one card, in turns.
``bits`` runs phase 8's tier batch and each tier's single query 30 times
each way (eager, fused) and prints, per tier, how their scores differ from
the first eager run's: in docs, in ulps, or in the sign of a zero.
``--docs`` sets the first segment's docs for phases 8, 9, 12 and 18 (5M, as in
``chip_smoke.py``; the index of phase 12 adds a quarter of it and 1,000
docs, built or loaded from ``.bench_cache/``); phase 12 holds the sharded
result against ``prepare_all``'s over the same index.
``--cli-docs`` and ``--cli-segment-docs`` set phase 14's docs and flush
threshold (``chip_smoke.CLI_DOCS``, ``CLI_SEGMENT_DOCS``). Failures are
printed and the next phase runs; the exit code is 1 if one failed.
"""

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GLOO = r"""
import sys, torch, torch.distributed as dist
rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method="tcp://localhost:" + port, world_size=2, rank=rank)
x = torch.full((3, 4), float(rank), device="cuda:0")
out = [torch.empty_like(x) for _ in range(2)]
dist.all_gather(out, x)
torch.cuda.synchronize()
print("GLOO_CUDA_ALLGATHER_OK", [o[0, 0].item() for o in out], out[1].device, flush=True)
dist.destroy_process_group()
"""


def gloo_check():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    procs = [subprocess.Popen([sys.executable, "-c", GLOO, str(r), port],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=120)
        print(f"gloo worker rc {p.returncode}: {out[-1500:]}", flush=True)
        if p.returncode != 0:
            raise RuntimeError("gloo all_gather of CUDA tensors failed")


def gather_forms(torch, cs):
    import numpy as np
    import torch.nn.functional as F

    from iresearch_tpu_torch.analysis import embed

    dev = torch.device("cuda", 0)
    t = time.perf_counter()
    texts, labels = cs.embed_corpus(cs.EMBED_DOCS, cs.EMBED_SEED)
    vocab = sorted({w for tx in texts for w in tx})
    model = embed.EmbeddingModel(vocab, np.zeros((len(vocab) + (1 << 15), 16), np.float32),
                                 sorted(set(labels)), None, buckets=1 << 15)
    R, M = embed.doc_rows(model, texts)
    print(f"rows {R.shape} in {time.perf_counter() - t:.3f} s", flush=True)
    lab = {b: i for i, b in enumerate(sorted(set(labels)))}
    y = torch.tensor([lab[b] for b in labels], device=dev)
    N, maxr = R.shape
    V = len(vocab) + (1 << 15)
    emb0 = (np.random.default_rng(0).standard_normal((V, 16)) / 16).astype(np.float32)
    Rt = torch.from_numpy(R).to(dev)
    Rl = Rt.long()
    Mt = torch.from_numpy(M).to(dev)
    denom = Mt.sum(1).clamp_min(1.0)[:, None]
    mask = M > 0
    flat = torch.from_numpy(R[mask]).to(dev)
    doc_of = torch.from_numpy(np.nonzero(mask)[0]).to(dev)
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(mask.sum(1))[:-1]])).to(dev)
    print(f"real rows {flat.numel()} of {N * maxr}", flush=True)

    def loss_of(doc, out):
        logits = doc @ out.T
        return (torch.logsumexp(logits, 1) - logits.gather(1, y[:, None])[:, 0]).mean()

    forms = {
        "embedding": lambda emb: (F.embedding(Rt, emb) * Mt[:, :, None]).sum(1) / denom,
        "index": lambda emb: (emb[Rl] * Mt[:, :, None]).sum(1) / denom,
        "index_select": lambda emb: (emb.index_select(0, Rt.reshape(-1)).reshape(N, maxr, 16)
                                     * Mt[:, :, None]).sum(1) / denom,
        "csr_index_add": lambda emb: torch.zeros(N, 16, device=dev).index_add(
            0, doc_of, F.embedding(flat, emb)) / denom,
        "embedding_bag": lambda emb: F.embedding_bag(flat, emb, offsets, mode="sum") / denom,
    }
    ref = None
    for name, form in forms.items():
        emb = torch.from_numpy(emb0).to(dev).requires_grad_()
        out = torch.full((len(lab), 16), 0.01, device=dev).requires_grad_()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            g, go = torch.autograd.grad(loss_of(form(emb), out), (emb, out))
            with torch.no_grad():
                emb -= 0.5 * g
                out -= 0.5 * go
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated(dev)
        e = emb.detach().cpu().numpy()
        ref = e if ref is None else ref
        print(f"GATHER {name}: step {np.mean(times[1:]):.4f} s (first {times[0]:.3f}), peak "
              f"{peak / 1e9:.2f} GB, max |emb - embedding's| {np.abs(e - ref).max():.3g}",
              flush=True)
        del emb, out, g, go
        torch.cuda.empty_cache()


def score_bits(torch, cs, sr, dev, smi, runs=30):
    """Which tier's scores differ between runs of the same call, and how:
    phase 8's tier batch (one group per tier) and each tier's single query,
    each run ``runs`` times eager and ``runs`` times fused, every run held
    against the first eager run. Prints per tier the runs whose docs or
    score bits differ, the largest distance in ulps between finite scores
    (their int32 views, the signs equal) and the lanes that differ only in
    the sign of a zero."""
    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.search.scorers import BM25

    scorer, k = BM25(), bench_mix.K
    prep, tasks = cs.tier_batch(sr, scorer, k, dev)
    runners = {f"batch {t}": (lambda fused, i=i: prep.run_grouped(fused)[i][0])
               for i, (t, _f, _k) in enumerate(tasks)}
    for tier, (flt, wand, knobs, dp) in bench_mix.single_tier_tasks(sr).items():
        dq = cs.single_query(sr, flt, scorer, dev, wand, knobs, dp)
        runners[f"single {tier}"] = (
            lambda fused, dq=dq: tuple(t[None] for t in dq.execute_segment_async(0, k, fused=fused)))
    for name, run in runners.items():
        ref_v, ref_d = (t.clone() for t in run(False))
        stats = {False: [0, 0, 0, 0], True: [0, 0, 0, 0]}  # docs, bits, max ulp, signed zeros
        for fused in (False, True):
            for _ in range(runs):
                v, d = run(fused)
                st = stats[fused]
                if not torch.equal(d, ref_d):
                    st[0] += 1
                    continue
                a, b = v.view(torch.int32), ref_v.view(torch.int32)
                if torch.equal(a, b):
                    continue
                st[1] += 1
                same = (v == ref_v) & (a != b)
                fin = torch.isfinite(v) & torch.isfinite(ref_v) & ((a < 0) == (b < 0)) & ~same
                st[2] = max(st[2], int((a[fin].long() - b[fin].long()).abs().max()) if fin.any() else 0)
                st[3] += int(same.sum())
        print(f"BITS {name:16s} over {runs} runs each way against the first eager run: "
              f"eager docs differ {stats[False][0]}, score bits {stats[False][1]} (max "
              f"{stats[False][2]} ulp, {stats[False][3]} signed-zero lanes); fused docs "
              f"differ {stats[True][0]}, score bits {stats[True][1]} (max {stats[True][2]} "
              f"ulp, {stats[True][3]} signed-zero lanes) on {smi}", flush=True)


def eager_turns(torch, srs, dev, smi, turns=2):
    """The eager sharded pass of phase 10's mix over ``srs``, one shard
    (``device=dev``) against four shards on ``dev`` (the mesh of phase 17),
    synchronised, in turns (one, mesh, mesh, one) ``turns`` times after a
    warm pass each, with no graph held: whether the mesh's eager pass costs
    more than one shard's when nothing else differs."""
    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.exec import batch as B
    from iresearch_tpu_torch.parallel import ShardedSearcher
    from iresearch_tpu_torch.search.scorers import BM25

    B.clear_fused_cache()
    filters = [f for _c, f in bench_mix.task_mix(srs[0])]
    preps = {name: ShardedSearcher(srs, **kw).prepare_many(filters, BM25(), wand=True, k_max=10)
             for name, kw in (("one shard", dict(device=dev)), ("mesh", dict(devices=[dev] * 4)))}
    ms = {name: [] for name in preps}
    for name in preps:
        preps[name].run(10, fused=False)
    for _ in range(turns):
        for name in ("one shard", "mesh", "mesh", "one shard"):
            torch.cuda.synchronize()
            t = time.perf_counter()
            preps[name].run(10, fused=False)
            torch.cuda.synchronize()
            ms[name].append(round((time.perf_counter() - t) * 1e3, 4))
    for name, xs in ms.items():
        print(f"EAGER {name}: {xs} ms a pass, synchronised, in turns on {smi}", flush=True)


def run_query_phase(torch, cs, step, index, dev, smi, profile=None):
    """Phase 8, 9, 12, 17, 18 or 19 of ``chip_smoke.py`` on the segments
    ``index(n)`` gives (phases 12 and 17 with ``chip_smoke.py``'s profiler
    breakdown, fused and eager, when ``profile`` names a file; phases 17
    and 19 held against a one-shard pass of their own, not phase 12's;
    phase 19 runs after phase 17, whose result and launches it takes)."""
    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.exec.batch import QueryBatch
    from iresearch_tpu_torch.kernels import build as kb
    from iresearch_tpu_torch.search.scorers import BM25

    scorer, k = BM25(), bench_mix.K
    kind = torch.cuda.get_device_name(0)
    if step == "8":
        sr = index(1)[0]
        cs.run_breadth(torch, sr, scorer, k, dev, smi)
        print(cs.run_single_tiers(torch, sr, scorer, k, dev, smi))
    elif step == "bits":
        score_bits(torch, cs, index(1)[0], dev, smi)
    elif step == "eager":
        eager_turns(torch, index(3), dev, smi)
    elif step == "18":
        print(cs.run_bench(torch, index(1)[0], dev, smi, kind))
    elif step == "9":
        sr = index(1)[0]
        kern = {name: {} for name in kb.KERNELS}
        print(cs.run_phrases(torch, sr, scorer, k, dev, smi, kern,
                             cs.launch_floor(torch, dev)))
    else:
        from iresearch_tpu_torch.parallel import ShardedSearcher

        srs = index(3)
        tasks = bench_mix.task_mix(srs[0])
        filters = [f for _c, f in tasks]
        vals, docs = QueryBatch(filters, srs, scorer, wand=True, device=dev).prepare_all(k).run()
        merged = (vals.cpu().numpy(), docs.cpu().numpy())
        if step == "12":
            print(cs.run_sharded(torch, srs, tasks, scorer, k, dev, smi, kind, profile, merged)[0])
        else:
            out = ShardedSearcher(srs, device=dev).prepare_many(
                filters, scorer, wand=True, k_max=k).run(k)
            one = tuple(torch.stack(x).cpu().numpy() for x in zip(*out))
            launches, mesh_pass, mesh_out = cs.run_mesh(torch, srs, tasks, scorer, k, smi, kind,
                                                        merged, one, profile)
            print(launches)
            if step == "19":
                cache = os.path.join(REPO, ".bench_cache")
                paths = [bench_mix.segment_path(sr.num_docs, cache, si)
                         for si, sr in enumerate(srs)]
                print(cs.run_nccl(torch, srs, paths, tasks, scorer, k, smi, kind, mesh_pass,
                                  mesh_out, one))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phases", nargs="*",
                    choices=["8", "9", "12", "14", "15", "16", "17", "18", "19", "bits",
                             "eager"])
    ap.add_argument("--docs", type=int, default=5_000_000)
    ap.add_argument("--profile", metavar="FILE",
                    help="phases 12, 17: also profile a fused and an eager pass; tables to FILE.*")
    ap.add_argument("--gloo", action="store_true")
    ap.add_argument("--gather-forms", action="store_true")
    ap.add_argument("--cli-docs", type=int)
    ap.add_argument("--cli-segment-docs", type=int)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from iresearch_tpu_torch.kernels import build as kb

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip().splitlines()
    smi = cards[0] if len(cards) == 1 else f"{len(cards)} x " + " | ".join(sorted(set(cards)))
    print(f"{smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    cs.CLI_DOCS = args.cli_docs or cs.CLI_DOCS
    cs.CLI_SEGMENT_DOCS = args.cli_segment_docs or cs.CLI_SEGMENT_DOCS
    failed = False
    steps = (["gloo"] if args.gloo else []) + (["gather"] if args.gather_forms else [])
    cache = os.path.join(REPO, ".bench_cache")
    os.makedirs(cache, exist_ok=True)
    dev = torch.device("cuda", 0)
    kb.library()
    segments = []

    def index(n):
        # chip_smoke.py's segments: seeds 42, 43, 44 at --docs, a quarter
        # of it and 1,000 docs
        from iresearch_tpu_torch import bench_mix
        from iresearch_tpu_torch.index.segment import SegmentReader

        sizes = [args.docs, max(2_000, args.docs // 4), 1_000]
        for si in range(len(segments), n):
            data, _cached = bench_mix.load_or_build(sizes[si], cache, si)
            segments.append(SegmentReader(f"smoke{si}" if si else "smoke", data))
            segments[-1].dense_cache("body")
        return segments[:n]

    for step in steps + args.phases:
        t0 = time.perf_counter()
        try:
            with tempfile.TemporaryDirectory(dir=cache) as tmp:
                if step == "gloo":
                    gloo_check()
                elif step == "gather":
                    gather_forms(torch, cs)
                elif step in ("8", "9", "12", "17", "18", "19", "bits", "eager"):
                    run_query_phase(torch, cs, step, index, dev, smi, args.profile)
                elif step == "14":
                    print(cs.run_cli(torch, 1_250_000, dev, smi, tmp))
                elif step == "15":
                    cs.run_embed(torch, cs.EMBED_DOCS, dev, smi, tmp)
                else:
                    print(cs.run_multihost(smi))
        except Exception:
            failed = True
            traceback.print_exc()
            sys.stdout.flush()
        print(f"step {step}: {time.perf_counter() - t0:.3f} s", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
