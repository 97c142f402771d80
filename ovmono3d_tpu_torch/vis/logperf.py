"""AP report tables (reference cubercnn/vis/logperf.py — SURVEY.md §2.1 #26).

Plain-text tables without the tabulate/termcolor deps: per-category AP,
per-dataset analysis rollups, and the headline 13-stat summary.

A copy of ovmono3d_tpu/vis/logperf.py: the port imports nothing of the JAX package, and a test
holds the copy to it.
"""
from __future__ import annotations


def _table(headers: list[str], rows: list[list]) -> str:
    widths = [
        max(len(str(h)), *(len(str(r[i])) for r in rows)) if rows else len(h)
        for i, h in enumerate(headers)
    ]

    def fmt_row(vals):
        return " | ".join(str(v).ljust(w) for v, w in zip(vals, widths))

    sep = "-+-".join("-" * w for w in widths)
    lines = [fmt_row(headers), sep]
    lines += [fmt_row(r) for r in rows]
    return "\n".join(lines)


def _fmt(v) -> str:
    try:
        return f"{float(v):.2f}"
    except (TypeError, ValueError):
        return str(v)


def print_ap_summary(results: dict[str, float], title: str = "") -> str:
    rows = [[k, _fmt(v)] for k, v in results.items()]
    out = (f"== {title} ==\n" if title else "") + _table(
        ["metric", "value"], rows
    )
    print(out)
    return out


def print_ap_per_category(
    per_cat: dict[str, float], title: str = "per-category AP"
) -> str:
    rows = [[name, _fmt(ap)] for name, ap in sorted(per_cat.items())]
    out = f"== {title} ==\n" + _table(["category", "AP"], rows)
    print(out)
    return out


def print_ap_analysis(
    dataset_results: dict[str, dict[str, float]],
    metrics: tuple[str, ...] = ("AP2D", "AP3D", "AP3D@15", "AP3D@25",
                                "AP3D@50"),
) -> str:
    headers = ["dataset", *metrics]
    rows = [
        [name, *[_fmt(res.get(m, float("nan"))) for m in metrics]]
        for name, res in dataset_results.items()
    ]
    out = _table(headers, rows)
    print(out)
    return out
