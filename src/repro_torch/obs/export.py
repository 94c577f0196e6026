"""Trace export: JSONL span stream -> Chrome ``trace_event`` JSON.

    python -m repro_torch.obs.export trace.jsonl --chrome -o trace.chrome.json

The output loads directly in ``chrome://tracing`` / Perfetto: each span
becomes one complete ("ph": "X") event with its attributes under
``args``; pid/tid come from the emitting process/thread so a 3-process
socket smoke renders as three lanes.  Without ``--chrome`` the tool
just validates the stream and prints a per-span-name summary.
"""
from __future__ import annotations

import argparse
import json
import sys

__all__ = ["load_spans", "to_chrome", "summarize", "main"]


def load_spans(path) -> list[dict]:
    """Strictly parse a trace JSONL file to a list of span dicts.

    Meta header lines are skipped; any non-JSON or non-span line raises
    (a truncated or interleaved trace should fail loudly, not render a
    misleading timeline).
    """
    spans = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: not JSON: {e}") from None
            if "meta" in ev:
                continue
            for key in ("name", "sid", "ts_us", "dur_us"):
                if key not in ev:
                    raise ValueError(
                        f"{path}:{lineno}: span record missing {key!r}")
            spans.append(ev)
    return spans


def to_chrome(spans: list[dict]) -> dict:
    """Spans -> Chrome trace_event 'complete event' JSON object."""
    events = []
    for ev in spans:
        events.append({
            "ph": "X",
            "name": ev["name"],
            "ts": ev["ts_us"],
            "dur": ev["dur_us"],
            "pid": ev.get("pid", 0),
            "tid": ev.get("tid", 0),
            "args": ev.get("attrs", {}),
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def summarize(spans: list[dict]) -> str:
    by_name: dict[str, list[float]] = {}
    for ev in spans:
        by_name.setdefault(ev["name"], []).append(ev["dur_us"])
    lines = [f"{len(spans)} spans, {len(by_name)} names"]
    for name in sorted(by_name):
        durs = by_name[name]
        lines.append(
            f"  {name:<28} n={len(durs):<5} total={sum(durs)/1e3:9.2f}ms "
            f"max={max(durs)/1e3:8.2f}ms")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.export",
        description="validate / convert bloom-clock trace JSONL")
    p.add_argument("trace", help="trace.jsonl emitted by obs.Tracer")
    p.add_argument("--chrome", action="store_true",
                   help="emit Chrome trace_event JSON")
    p.add_argument("-o", "--out", default=None,
                   help="output path (default: stdout)")
    args = p.parse_args(argv)

    spans = load_spans(args.trace)
    if args.chrome:
        out = json.dumps(to_chrome(spans))
        if args.out:
            with open(args.out, "w") as f:
                f.write(out)
            print(f"wrote {args.out}: {len(spans)} events")
        else:
            print(out)
    else:
        print(summarize(spans))
    return 0


if __name__ == "__main__":
    sys.exit(main())
