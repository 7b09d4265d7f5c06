"""Observability: tab-separated symbol logs and stdout teeing (the port's
copy of back2future_tpu/utils/logger.py:18,129, which imports no
framework; the port keeps its own so that it imports nothing of the JAX
package).

Rebuilds the reference logging surface (myLogger.lua:40-193 and
myCmdLine's `:log` tee, myCmdLine.lua:191-221): `SymbolLogger` appends
named values as TSV rows with a header derived from the first `add`
(used for train.log / test.log per epoch), and `plot()` renders the
series to a standalone SVG (the reference shelled out to gnuplot for an
.eps, myLogger.lua:137-192; SVG keeps it dependency-free); `TeeLogger`
duplicates stdout into `<save>/log`. Both files are byte for byte what
the JAX package writes for the same calls."""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict, Iterable, Optional


class SymbolLogger:
    """Tab-separated per-epoch metric log (myLogger.lua:40-135)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._names: Optional[list] = None
        if self.path.exists():
            header = self.path.read_text().splitlines()
            if header:
                # rstrip: the reference writes a trailing tab after the
                # last column (myLogger.lua:74-79), so a resumed log —
                # ours or an actual Lua-written one — parses identically
                self._names = header[0].rstrip("\t").split("\t")

    def add(self, symbols: Dict[str, float]) -> None:
        """Append one row (myLogger.lua:84-114): every value formatted
        `%11.4e` with a trailing tab per column — byte-format compatible
        with the reference's train.log/test.log consumers."""
        if self._names is None:
            self._names = list(symbols.keys())
            with open(self.path, "a") as f:
                f.write("".join(n + "\t" for n in self._names) + "\n")
        missing = set(symbols) - set(self._names)
        if missing:
            raise ValueError(f"unknown log symbols {sorted(missing)}; "
                             f"header has {self._names}")
        row = "".join(f"{float(symbols.get(n, float('nan'))):11.4e}\t"
                      for n in self._names)
        with open(self.path, "a") as f:
            f.write(row + "\n")

    def read(self) -> Dict[str, list]:
        lines = self.path.read_text().splitlines()
        names = lines[0].rstrip("\t").split("\t")
        cols: Dict[str, list] = {n: [] for n in names}
        for line in lines[1:]:
            for n, v in zip(names, line.rstrip("\t").split("\t")):
                cols[n].append(float(v))
        return cols

    def style(self, styles: Dict[str, str]) -> None:
        """Per-symbol plot style, '-' lines (default) or '+' points
        (myLogger.lua:100-118's gnuplot styles)."""
        self._styles = dict(getattr(self, "_styles", {}), **styles)

    def plot(self, out_path: Optional[str | Path] = None,
             names: Optional[Iterable[str]] = None,
             width: int = 720, height: int = 420) -> Path:
        """Render the logged series to `<log>.svg` (myLogger.lua:137-192).

        Dependency-free SVG: one polyline (or point markers, see
        `style`) per symbol over the row index (epoch), with axis ticks
        and a legend. Returns the output path."""
        cols = self.read()
        names = [n for n in (names or cols) if cols.get(n)]
        if not names:
            raise ValueError("nothing to plot")
        styles = getattr(self, "_styles", {})
        palette = ["#1f77b4", "#d62728", "#2ca02c", "#ff7f0e", "#9467bd",
                   "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf"]
        ml, mr, mt, mb = 56, 16, 16, 36  # margins
        pw, ph = width - ml - mr, height - mt - mb
        n_rows = max(len(cols[n]) for n in names)
        vals = [v for n in names for v in cols[n]
                if v == v and abs(v) != float("inf")]
        lo, hi = (min(vals), max(vals)) if vals else (0.0, 1.0)
        if hi == lo:
            hi = lo + 1.0

        def sx(i):
            return ml + (pw * i / max(n_rows - 1, 1))

        def sy(v):
            return mt + ph * (1 - (v - lo) / (hi - lo))

        parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
                 f'height="{height}" font-family="sans-serif" font-size="11">',
                 f'<rect width="{width}" height="{height}" fill="white"/>',
                 f'<rect x="{ml}" y="{mt}" width="{pw}" height="{ph}" '
                 f'fill="none" stroke="#888"/>']
        for k in range(5):  # y ticks
            v = lo + (hi - lo) * k / 4
            y = sy(v)
            parts.append(f'<line x1="{ml}" y1="{y:.1f}" x2="{ml + pw}" '
                         f'y2="{y:.1f}" stroke="#eee"/>')
            parts.append(f'<text x="{ml - 6}" y="{y + 4:.1f}" '
                         f'text-anchor="end">{v:.4g}</text>')
        for k in range(min(n_rows, 6)):  # x ticks (epoch index, 1-based)
            i = round(k * (n_rows - 1) / max(min(n_rows, 6) - 1, 1))
            parts.append(f'<text x="{sx(i):.1f}" y="{mt + ph + 16}" '
                         f'text-anchor="middle">{i + 1}</text>')
        for j, n in enumerate(names):
            color = palette[j % len(palette)]
            pts = [(sx(i), sy(v)) for i, v in enumerate(cols[n])
                   if v == v and abs(v) != float("inf")]
            if styles.get(n) == "+":
                parts += [f'<circle cx="{x:.1f}" cy="{y:.1f}" r="2.5" '
                          f'fill="{color}"/>' for x, y in pts]
            else:
                poly = " ".join(f"{x:.1f},{y:.1f}" for x, y in pts)
                parts.append(f'<polyline points="{poly}" fill="none" '
                             f'stroke="{color}" stroke-width="1.5"/>')
            parts.append(f'<text x="{ml + 10}" y="{mt + 16 + 14 * j}" '
                         f'fill="{color}">{n}</text>')
        parts.append("</svg>")
        out = Path(out_path) if out_path else self.path.with_suffix(".svg")
        out.write_text("\n".join(parts))
        return out


class TeeLogger:
    """Duplicate stdout into a logfile (myCmdLine.lua:191-221)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._file = open(self.path, "a")
        self._stdout = sys.stdout

    def __enter__(self):
        sys.stdout = self
        return self

    def __exit__(self, *exc):
        sys.stdout = self._stdout
        self._file.close()

    def write(self, s: str):
        self._stdout.write(s)
        self._file.write(s)

    def flush(self):
        self._stdout.flush()
        self._file.flush()
