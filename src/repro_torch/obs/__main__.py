"""``python -m repro_torch.obs summarize trace.json``: terminal summary
of an exported Chrome trace (per-span totals, instant-event counts)."""
from __future__ import annotations

import argparse
from typing import Sequence

from repro_torch.obs import chrome


def main(argv: Sequence[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("summarize",
                       help="per-name aggregate table of a Chrome trace")
    p.add_argument("path", help="Chrome trace-event JSON file "
                                "(obs.export_chrome output)")
    args = ap.parse_args(argv)
    trace = chrome.load(args.path)
    n = chrome.validate(trace)
    print(f"{args.path}: {n} events")
    print(chrome.summarize(trace))


if __name__ == "__main__":
    main()
