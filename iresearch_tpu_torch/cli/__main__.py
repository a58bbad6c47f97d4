"""Mode dispatcher (reference: utils/main.cpp)."""

import sys


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    # accept both `put ...` and `-m put ...` (reference CLI uses -m)
    mode = None
    if argv and argv[0] == "-m":
        mode = argv[1]
        rest = argv[2:]
    elif argv and not argv[0].startswith("-"):
        mode = argv[0]
        rest = argv[1:]
    else:
        rest = argv
    if mode == "put":
        from iresearch_tpu_torch.cli.index_put import main as run
    elif mode == "search":
        from iresearch_tpu_torch.cli.index_search import main as run
    elif mode == "dump":
        from iresearch_tpu_torch.cli.index_dump import main as run
    elif mode == "convert":
        from iresearch_tpu_torch.cli.index_convert import main as run
    else:
        print(
            "usage: python -m iresearch_tpu_torch.cli {put|search|dump|convert} ...",
            file=sys.stderr,
        )
        return 2
    return run(rest)


if __name__ == "__main__":
    sys.exit(main())
