"""Stacked abundance barplot, as one self-contained HTML file —
counterpart of ``monica_tpu/plots/barplot.py``, on the port's tables
(:class:`monica_tpu_torch.stats.abundance.Table`) instead of DataFrames.

The HTML is byte-equal to the JAX package's for the same tables, so the
port reproduces the pandas arithmetic the reference plot runs on:

* :func:`by_taxunit` sums accession rows into tax-unit rows in order of
  first appearance with missing cells as 0, compensated (Kahan) as
  pandas' grouped sum is; a plain sum can differ in the last bit, which
  shows in the JSON inside the HTML;
* :func:`filter_low_reads` keeps the tax units whose raw counts exceed
  the threshold in some sample, in the raw table's order;
* the ranking by maximum abundance sorts as pandas'
  ``sort_values(ascending=False)`` does: numpy's quicksort on the
  reversed values, reversed back, so ties come out as in the reference;
* the first 8 taxa get the palette's slots and the rest fold into a gray
  "Other" bar whose values are numpy's column sums of their rows.
"""

from __future__ import annotations

import html as _html
import json
import os
from pathlib import Path

import numpy as np

from monica_tpu_torch.stats.abundance import Table

BARPLOT_FILENAME = "monica.barplot.html"
READS_THRESHOLD = 15  # reference default

# Validated categorical palette (8 slots, fixed order; light/dark steps).
_SERIES_LIGHT = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4", "#008300", "#4a3aa7", "#e34948"]
_SERIES_DARK = ["#3987e5", "#d95926", "#199e70", "#c98500", "#d55181", "#008300", "#9085e9", "#e66767"]
_OTHER_LIGHT, _OTHER_DARK = "#8a8984", "#706f6a"


def by_taxunit(table: Table) -> tuple[list[str], np.ndarray]:
    """(tax units in order of first appearance, (units, samples) sums of
    their accession rows, missing cells as 0), each sum compensated as
    pandas' grouped float sum is."""
    vals = np.where(np.isnan(table.values), 0.0, table.values)
    groups: dict[str, int] = {}
    labels = [groups.setdefault(tax, len(groups)) for tax, _ in table.index]
    sums = np.zeros((len(groups), len(table.samples)))
    comp = np.zeros_like(sums)
    for i, g in enumerate(labels):
        y = vals[i] - comp[g]
        t = sums[g] + y
        c = t - sums[g] - y
        c[np.isnan(c)] = 0.0  # an infinite value: keep the sum infinite
        comp[g] = c
        sums[g] = t
    return list(groups), sums


def filter_low_reads(norm: tuple[list[str], np.ndarray], raw: tuple[list[str], np.ndarray],
                     threshold: float) -> tuple[list[str], np.ndarray]:
    """Drop the tax units whose raw counts are <= threshold in every
    sample; the kept units come in the raw table's order."""
    taxa, vals = norm
    raw_taxa, raw_vals = raw
    row = {t: i for i, t in enumerate(taxa)}
    keep = (raw_vals > float(threshold)).any(axis=1)
    kept = [t for t, k in zip(raw_taxa, keep) if k and t in row]
    return kept, vals[[row[t] for t in kept]].reshape(len(kept), vals.shape[1])


def _rank_descending(x: np.ndarray) -> np.ndarray:
    """The order of ``Series.sort_values(ascending=False)`` (quicksort,
    NaN last), ties included."""
    mask = np.isnan(x)
    idx = np.arange(len(x))
    non_nans = x[~mask][::-1]
    non_nan_idx = idx[~mask][::-1]
    indexer = non_nan_idx[non_nans.argsort(kind="quicksort")][::-1]
    return np.concatenate([indexer, np.nonzero(mask)[0]])


def plotter(
    norm_alignment_df: Table,
    raw_alignment_df: Table,
    output_folder: str | os.PathLike,
    reads_threshold: float = READS_THRESHOLD,
    hosts: list[str] | None = None,
    guests: list[str] | None = None,
    mode: str | None = None,
    show_legend: bool = True,
    auto_open: bool = False,
) -> Path:
    """Render the stacked relative-abundance barplot to
    ``<output_folder>/monica.barplot.html``; returns the path."""
    taxa, vals = filter_low_reads(by_taxunit(norm_alignment_df), by_taxunit(raw_alignment_df),
                                  reads_threshold)
    samples = list(norm_alignment_df.samples)
    hosts = hosts or []
    guests = guests or []
    if hosts and guests:
        title = f"Guests: {', '.join(guests)}; host: {', '.join(hosts)}; analysis mode: {mode}"
    elif hosts:
        title = f"Host: {', '.join(hosts)}; analysis mode: {mode}"
    elif guests:
        title = f"Guests: {', '.join(guests)}; analysis mode: {mode}"
    else:
        title = f"Analysis mode: {mode}"

    # rank taxa by max abundance; first 8 get palette slots, rest fold
    peak = vals.max(axis=1) if vals.shape[1] else np.full(len(taxa), np.nan)
    ranked = _rank_descending(peak)
    series = []
    for i, r in enumerate(ranked[:8]):
        taxon = taxa[r]
        series.append({
            "name": f"{taxon}_(host)" if taxon in hosts else str(taxon),
            "taxon": str(taxon),
            "values": [float(v) for v in vals[r]],
            "cl": _SERIES_LIGHT[i],
            "cd": _SERIES_DARK[i],
        })
    rest = ranked[8:]
    if len(rest):
        other = vals[rest].sum(axis=0)
        series.append({
            "name": f"Other ({len(rest)} taxa)",
            "taxon": "Other",
            "values": [float(v) for v in other],
            "cl": _OTHER_LIGHT,
            "cd": _OTHER_DARK,
        })

    # full table rows (all taxa, unfolded) for the table view
    table_rows = [[str(taxa[r])] + [float(v) for v in vals[r]] for r in ranked]

    html_text = _render_html(title, samples, series, table_rows, show_legend)
    output_folder = Path(output_folder)
    output_folder.mkdir(parents=True, exist_ok=True)
    out = output_folder / BARPLOT_FILENAME
    out.write_text(html_text)
    if auto_open:
        import webbrowser

        webbrowser.open(out.resolve().as_uri())
    return out


def _render_html(title, samples, series, table_rows, show_legend) -> str:
    payload = json.dumps({"samples": samples, "series": series, "rows": table_rows})
    legend_css = "" if show_legend else "#legend{display:none}"
    return f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{_html.escape(title)}</title>
<style>
.viz-root {{
  color-scheme: light;
  --surface-1:#fcfcfb; --text-primary:#0b0b0b; --text-secondary:#52514e;
  --grid:#e8e7e3;
  font:14px/1.45 system-ui,-apple-system,sans-serif;
  background:var(--surface-1); color:var(--text-primary);
  max-width:960px; margin:2rem auto; padding:0 1rem;
}}
@media (prefers-color-scheme: dark) {{
  :root:where(:not([data-theme="light"])) .viz-root {{
    color-scheme:dark; --surface-1:#1a1a19; --text-primary:#ffffff;
    --text-secondary:#c3c2b7; --grid:#34332f;
  }}
}}
h1 {{ font-size:1.1rem; font-weight:600; }}
svg text {{ fill:var(--text-secondary); font-size:12px; }}
#legend {{ display:flex; flex-wrap:wrap; gap:.4rem 1rem; margin:.6rem 0; }}
#legend span {{ display:inline-flex; align-items:center; gap:.35rem;
  color:var(--text-secondary); font-size:12.5px; }}
#legend i {{ width:10px; height:10px; border-radius:3px; display:inline-block; }}
#tooltip {{ position:fixed; pointer-events:none; background:var(--surface-1);
  color:var(--text-primary); border:1px solid var(--grid); border-radius:6px;
  padding:.35rem .6rem; font-size:12.5px; opacity:0; transition:opacity .1s;
  box-shadow:0 2px 8px rgba(0,0,0,.15); }}
details {{ margin-top:1rem; color:var(--text-secondary); }}
table {{ border-collapse:collapse; font-size:12.5px; margin-top:.5rem; }}
td,th {{ border:1px solid var(--grid); padding:.25rem .55rem; text-align:right; }}
th:first-child, td:first-child {{ text-align:left; }}
{legend_css}
</style></head>
<body><div class="viz-root">
<h1>{_html.escape(title)}</h1>
<div id="legend"></div>
<svg id="chart" width="920" height="430" role="img" aria-label="Stacked relative abundance per sample"></svg>
<div id="tooltip"></div>
<details><summary>Data table (all taxa)</summary><div id="table"></div></details>
<script>
const D = {payload};
const dark = matchMedia('(prefers-color-scheme: dark)').matches;
const col = s => dark ? s.cd : s.cl;
const svg = document.getElementById('chart');
const NS = 'http://www.w3.org/2000/svg';
const M = {{l:56, r:16, t:10, b:60}};
const W = 920 - M.l - M.r, H = 430 - M.t - M.b;
const n = D.samples.length;
const bw = Math.min(72, W/Math.max(n,1)*0.62);
const step = W/Math.max(n,1);
const totals = D.samples.map((_,i)=>D.series.reduce((a,s)=>a+s.values[i],0));
const ymax = Math.max(1e-9, ...totals);
function el(t,a){{const e=document.createElementNS(NS,t);for(const k in a)e.setAttribute(k,a[k]);return e;}}
// grid + y axis
for (let g=0; g<=4; g++) {{
  const y = M.t + H - H*g/4;
  svg.appendChild(el('line',{{x1:M.l,x2:M.l+W,y1:y,y2:y,stroke:'var(--grid)','stroke-width':1}}));
  const t=el('text',{{x:M.l-8,y:y+4,'text-anchor':'end'}});
  t.textContent=(ymax*g/4).toPrecision(2); svg.appendChild(t);
}}
const tip = document.getElementById('tooltip');
D.samples.forEach((smp,i)=>{{
  let y0 = M.t + H;
  const x = M.l + step*i + (step-bw)/2;
  D.series.forEach(s=>{{
    const v = s.values[i]; if (v<=0) return;
    const h = H*v/ymax;
    const r = el('rect',{{x:x, y:y0-h, width:bw, height:Math.max(h-2,0.8), rx:3,
      fill:col(s)}});
    r.addEventListener('mousemove',ev=>{{tip.style.opacity=1;
      tip.style.left=(ev.clientX+12)+'px'; tip.style.top=(ev.clientY-10)+'px';
      tip.innerHTML='<b>'+s.name+'</b><br>'+smp+': '+v.toPrecision(4);}});
    r.addEventListener('mouseleave',()=>tip.style.opacity=0);
    svg.appendChild(r);
    y0 -= h;
  }});
  const t=el('text',{{x:x+bw/2,y:M.t+H+18,'text-anchor':'middle'}});
  t.textContent=smp.length>14?smp.slice(0,13)+'…':smp; svg.appendChild(t);
}});
const leg = document.getElementById('legend');
D.series.forEach(s=>{{
  const sp=document.createElement('span');
  const i=document.createElement('i'); i.style.background=col(s);
  sp.appendChild(i); sp.appendChild(document.createTextNode(s.name));
  leg.appendChild(sp);
}});
const tb=document.getElementById('table');
let htmlT='<table><tr><th>tax unit</th>'+D.samples.map(s=>'<th>'+s+'</th>').join('')+'</tr>';
D.rows.forEach(r=>{{htmlT+='<tr><td>'+r[0]+'</td>'+r.slice(1).map(v=>'<td>'+Number(v).toPrecision(4)+'</td>').join('')+'</tr>';}});
tb.innerHTML=htmlT+'</table>';
</script>
</div></body></html>
"""
