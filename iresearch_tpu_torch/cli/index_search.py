"""Task-file query benchmark (reference: utils/index-search.cpp:490-780).

Parses luceneutil-style task lines ``Category: query text`` into the 22
reference categories (index-search.cpp:93-143), builds the equivalent
filters (prepareFilter, index-search.cpp:244-460), executes top-N per
category, and emits per-category CSV stats like the reference's
"Query execution" report.

Engines: ``device`` (the port's ``DeviceQuery`` on ``--device``, the card
unless named; the default), ``host`` (numpy oracle). Both produce identical
rankings.
"""

from __future__ import annotations

import argparse
import re
import sys
import time
from collections import defaultdict
from typing import List, Optional, Tuple

from iresearch_tpu_torch.index.reader import DirectoryReader
from iresearch_tpu_torch.search import filters as F
from iresearch_tpu_torch.search.scorers import get_scorer
from iresearch_tpu_torch.store.directory import FSDirectory

CATEGORIES = {
    "HighTerm", "MedTerm", "LowTerm",
    "HighPhrase", "MedPhrase", "LowPhrase",
    "AndHighHigh", "AndHighMed", "AndHighLow",
    "OrHighHigh", "OrHighMed", "OrHighLow",
    "Prefix3", "Wildcard", "Fuzzy1", "Fuzzy2",
    "Or4High", "Or6High4Med2Low", "MinMatch2High2Med",
    "HighNGram", "MedNGram", "LowNGram",
}

_FREQ1 = re.compile(r"(\S+)\s*#\s*(.+)")  # single term / prefix
_FREQ2 = re.compile(r"\"(.+)\"\s*#\s*(.+)")  # phrase
_FREQ3 = re.compile(r"((?:\S+\s+)+)\s*#\s*(.+)")  # AND/OR groups


def split_freq(text: str) -> Optional[str]:
    for rx in (_FREQ1, _FREQ2, _FREQ3):
        m = rx.fullmatch(text)
        if m:
            return m.group(1)
    return text or None


def build_filter(
    category: str, text: str, scored_terms_limit: int, field: str = "body"
) -> Optional[F.Filter]:
    """Task line -> filter (reference: prepareFilter)."""
    terms = split_freq(text)
    if terms is None:
        return None
    terms = terms.strip()
    if category in ("HighTerm", "MedTerm", "LowTerm"):
        return F.ByTerm(field, terms)
    if category in ("HighPhrase", "MedPhrase", "LowPhrase"):
        return F.ByPhrase(field, terms.split())
    if category in ("HighNGram", "MedNGram", "LowNGram"):
        parts = terms.split()
        threshold = int(parts[0]) / 10.0
        return F.ByNgramSimilarity(field, parts[1:], threshold=threshold)
    if category.startswith("AndHigh"):
        # terms carry a '+' prefix in the task file
        return F.And(*[F.ByTerm(field, t.lstrip("+")) for t in terms.split()])
    if category.startswith("OrHigh") or category in ("Or4High", "Or6High4Med2Low"):
        return F.Or(*[F.ByTerm(field, t) for t in terms.split()])
    if category == "Prefix3":
        return F.ByPrefix(
            field, text.rstrip("~"), scored_terms_limit=scored_terms_limit
        )
    if category == "Wildcard":
        pat = text.replace("*", "%").replace("?", "_")
        return F.ByWildcard(field, pat, scored_terms_limit=scored_terms_limit)
    if category in ("Fuzzy1", "Fuzzy2"):
        term = text.split("~")[0]
        return F.ByEditDistance(
            field,
            term,
            max_distance=1 if category == "Fuzzy1" else 2,
            scored_terms_limit=50,  # reference: max_terms = 50
        )
    if category == "MinMatch2High2Med":
        parts = terms.split()
        return F.Or(
            *[F.ByTerm(field, t) for t in parts[1:]], min_match=int(parts[0])
        )
    return None


def parse_tasks(
    lines, tasks_per_category: int
) -> List[Tuple[str, str]]:
    """(category, text) pairs, capped per category (prepareTasks)."""
    counts: defaultdict = defaultdict(int)
    out = []
    rx = re.compile(r"(\S+): (.+)")
    for line in lines:
        m = rx.fullmatch(line.rstrip("\n"))
        if not m or m.group(1) not in CATEGORIES:
            continue
        cat = m.group(1)
        counts[cat] += 1
        if counts[cat] <= tasks_per_category:
            out.append((cat, m.group(2)))
    return out


def parse_args(argv):
    p = argparse.ArgumentParser(prog="index_search")
    p.add_argument("--in", dest="input", required=True, help="task file")
    p.add_argument("--index-dir", required=True)
    p.add_argument("--repeat", type=int, default=1)
    p.add_argument("--max-tasks", type=int, default=1, help="tasks per category")
    p.add_argument("--topN", type=int, default=100)
    p.add_argument("--scorer", default="bm25")
    p.add_argument("--scorer-arg", default="{}")
    p.add_argument("--scored-terms-limit", type=int, default=16)
    p.add_argument("--engine", default="device", choices=["device", "host"])
    p.add_argument("--wand", action="store_true",
                   help="block-max pruning for eligible queries (exact)")
    p.add_argument("--wand-mode", default="exact",
                   choices=["exact", "strict", "approx"],
                   help="speed/recall knob (reference WandContext.strict, "
                   "index_reader_options.hpp:48-56): exact never prunes a "
                   "true top-k block; strict may drop float-tie boundary "
                   "docs; approx decodes only the sampled highest-bound "
                   "blocks (fastest, recall tradeoff)")
    p.add_argument("--device", default=None,
                   help="torch device of the device engine (default: the card)")
    p.add_argument("--csv", action="store_true")
    p.add_argument("--metrics-out", default=None,
                   help="write Prometheus text metrics to this file")
    return p.parse_args(argv)


def run_tasks(args, reader, tasks, scorer):
    """Run the tasks ``args.repeat`` times on ``args.engine``: (stats
    {category: [calls, seconds]}, results {(category, text): hits})."""
    stats: defaultdict = defaultdict(lambda: [0, 0.0])  # cat -> [calls, secs]
    results = {}
    for rep in range(args.repeat):
        for cat, text in tasks:
            flt = build_filter(cat, text, args.scored_terms_limit)
            if flt is None:
                continue
            t0 = time.time()
            if args.engine == "device":
                from iresearch_tpu_torch.exec import DeviceQuery

                dq = DeviceQuery(
                    flt, list(reader.segments), scorer, wand=args.wand,
                    wand_mode=args.wand_mode, device=args.device,
                )
                hits = dq.top_k(args.topN)
            else:
                from iresearch_tpu_torch.search.host_eval import search as search_host

                hits = search_host(reader, flt, scorer, k=args.topN)
            dt = time.time() - t0
            stats[cat][0] += 1
            stats[cat][1] += dt
            results[(cat, text)] = hits
    return stats, results


def main(argv) -> int:
    import json

    args = parse_args(argv)
    reader = DirectoryReader.open(FSDirectory(args.index_dir))
    scorer = get_scorer(args.scorer, json.loads(args.scorer_arg))
    with open(args.input, "r", encoding="utf-8", errors="replace") as fh:
        tasks = parse_tasks(fh, args.max_tasks)
    print(f"{len(tasks)} tasks, {reader.docs_count} docs", file=sys.stderr)

    stats, results = run_tasks(args, reader, tasks, scorer)

    if args.csv:
        print("category,calls,time_us,avg_us")
        for cat in sorted(stats):
            calls, secs = stats[cat]
            print(f"{cat},{calls},{secs*1e6:.0f},{secs*1e6/max(calls,1):.0f}")
    else:
        for cat in sorted(stats):
            calls, secs = stats[cat]
            print(f"{cat}: {calls} calls, {secs*1e3:.2f} ms total")
        for (cat, text), hits in list(results.items())[:3]:
            print(f"  sample [{cat}] {text!r}: top={hits[:3]}")
    if args.metrics_out:
        from iresearch_tpu_torch.utils.metrics import registry

        m = registry()
        for cat in stats:
            calls, secs = stats[cat]
            m.gauge("Time", secs * 1e6 / max(calls, 1),
                    {"category": cat, "engine": args.engine},
                    help_="query execution time (us)")
            m.gauge("Calls", calls, {"category": cat, "engine": args.engine})
        m.write(args.metrics_out)
    return 0
