"""``zoo-shm`` — operator CLI for the shared-memory object plane
(counterpart of ``analytics_zoo_tpu/shm/cli.py``), run as ``python -m
analytics_zoo_tpu_torch.shm.cli gc|stats``.

``gc`` sweeps every arena under the control root: leases of dead
processes are dropped, consumed-and-unpinned blobs are freed, unconsumed
blobs past the grace window (their producer died before any consumer saw
them) are reclaimed, and arenas left with no blobs and no leases are
destroyed with ``--purge-empty`` — the recovery path after a host crash
or a SIGKILLed fleet whose supervisor never ran its sweep.

``stats`` prints one JSON line per arena.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

from .arena import BlobArena, default_control_root


def _arena_roots(root: str) -> List[str]:
    if not os.path.isdir(root):
        return []
    return sorted(os.path.join(root, n) for n in os.listdir(root)
                  if os.path.isdir(os.path.join(root, n)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m analytics_zoo_tpu_torch.shm.cli",
        description="shared-memory object plane tooling")
    sub = p.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("gc", help="sweep dead leases + orphaned segments")
    g.add_argument("--root", default=default_control_root(),
                   help="control root holding the arenas "
                        "(default: %(default)s)")
    g.add_argument("--grace", type=float, default=300.0,
                   help="seconds an unconsumed, unpinned blob survives "
                        "before it is reclaimed as an orphan "
                        "(default: %(default)s)")
    g.add_argument("--purge-empty", action="store_true",
                   help="destroy arenas left with no blobs and no leases "
                        "(unlinks their segments)")
    s = sub.add_parser("stats", help="per-arena occupancy")
    s.add_argument("--root", default=default_control_root())
    args = p.parse_args(argv)

    roots = _arena_roots(args.root)
    if not roots:
        print(f"no arenas under {args.root}")
        return 0
    rc = 0
    for root in roots:
        try:
            arena = BlobArena(root, create=False)
            if args.cmd == "stats":
                print(json.dumps({"arena": root, **arena.stats()}))
                continue
            out = arena.gc(grace_s=args.grace)
            st = arena.stats()
            purged = False
            if args.purge_empty and st["allocs_live"] == 0 \
                    and st["leases"] == 0:
                arena.destroy()
                purged = True
            print(json.dumps({"arena": root, **out, "purged": purged,
                              "allocs_live": st["allocs_live"],
                              "leases": st["leases"]}))
        except Exception as e:  # noqa: BLE001 — keep sweeping the rest
            print(f"{root}: {type(e).__name__}: {e}", file=sys.stderr)
            rc = 1
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
