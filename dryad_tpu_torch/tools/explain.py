"""Query plan explain — the ``DryadLinqQueryExplain`` analog (a copy of
``dryad_tpu/tools/explain.py``).

The reference pretty-prints the optimized physical plan per submission
(``LinqToDryad/DryadLinqQueryExplain.cs``, artifacts
``QueryGraph__.txt``/``DryadLinqProgram__.xml``,
``DryadLinqQueryGen.cs:46-47``).  Here: a text rendering of (1) the
logical node DAG with partition metadata, (2) the stage graph the
executor will run and (3) the fusion decision (``plan/fuse.py``), plus
DOT and SVG drawings of the stage graph.  For the same query both
packages print the same text but for node and stage ids, which each
package draws from its own counters.  ``explain_diagnoses`` is the
runtime-diagnosis panel of ``Query.explain(analyze=True)``;
``explain_lint`` is the static-analysis panel of the port's graftlint
(``analysis/``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from dryad_tpu_torch.plan.lower import StageGraph
from dryad_tpu_torch.plan.nodes import Node, walk

# Stage-op kinds that imply a cross-partition exchange inside the
# compiled program (all_to_all / collective boundary).
_EXCHANGE_OPS = {"exchange_hash", "exchange_range"}


def _fmt_partition(node: Node) -> str:
    p = node.partition
    bits = [p.scheme]
    if p.keys:
        bits.append("keys=" + ",".join(p.keys))
    if p.range_by:
        bits.append(
            "range=" + ",".join(f"{n}{'v' if d else '^'}" for n, d in p.range_by)
        )
    if p.ordered_by:
        bits.append(
            "ordered=" + ",".join(f"{n}{'v' if d else '^'}" for n, d in p.ordered_by)
        )
    return " ".join(bits)


def explain_logical(roots: Sequence[Node]) -> str:
    """Render the logical DAG in topological order, one node per line."""
    lines = ["== logical plan =="]
    for n in walk(roots):
        ins = ",".join(f"#{i.id}" for i in n.inputs) or "-"
        cols = ",".join(n.schema.names)
        lines.append(
            f"#{n.id:<4} {n.kind:<16} <- {ins:<12} [{cols}]  ({_fmt_partition(n)})"
        )
    return "\n".join(lines)


def explain_stages(graph: StageGraph) -> str:
    """Render the fused stage graph (the SuperNode view)."""
    lines = ["== stage graph =="]
    for s in graph.stages:
        refs = []
        for ref, idx in s.input_refs:
            if ref == "plan_input":
                refs.append(f"input#{idx}")
            else:
                refs.append(f"stage{ref}.out{idx}")
        ops = " | ".join(
            f"{op.kind}{'*' if op.kind in _EXCHANGE_OPS else ''}" for op in s.ops
        )
        lines.append(
            f"stage {s.id:<3} {s.name:<40} <- {','.join(refs) or '-'}"
        )
        lines.append(f"      ops: {ops or '-'}   outs={len(s.out_slots)}"
                     + (f"  growth={s.growth:g}" if s.growth != 1.0 else ""))
    n_ex = sum(
        1 for s in graph.stages for op in s.ops if op.kind in _EXCHANGE_OPS
    )
    lines.append(f"-- {len(graph.stages)} stages, {n_ex} exchanges "
                 f"(* = cross-partition collective)")
    return "\n".join(lines)


def explain_fusion(graph: StageGraph, config) -> str:
    """Render the whole-DAG fusion decision (``plan.fuse``): which
    stages fuse into one dispatched program, and — per broken seam —
    the ``fuse_break_reason``, so fusion decisions are debuggable
    without reading the pass."""
    lines = ["== fusion =="]
    if not getattr(config, "plan_fuse", True):
        lines.append(
            "plan_fuse=off: every stage dispatches as its own program "
            f"({len(graph.stages)} dispatches)"
        )
        return "\n".join(lines)
    from dryad_tpu_torch.plan.fuse import fuse

    report = fuse(graph, config)
    names = {s.id: s.name for s in graph.stages}
    for r in report.regions:
        if r["fused"]:
            members = ", ".join(
                f"stage{sid} ({names.get(sid, '?')[:24]})"
                for sid in r["members"]
            )
            lines.append(
                f"region f{r['id']}: {len(r['members'])} stages -> ONE "
                f"dispatch  [{members}]"
            )
        else:
            why = f"  [{r['reason']}]" if r["reason"] else ""
            lines.append(
                f"stage {r['members'][0]:<4} "
                f"{names.get(r['members'][0], '?')[:40]:<40} unfused{why}"
            )
    for b in report.breaks:
        lines.append(
            f"  seam stage{b['after']} -> stage{b['before']}: "
            f"{b['reason']}"
        )
    lines.append(
        f"-- {report.n_stages} stages -> {report.n_dispatch_units} "
        "dispatches"
    )
    return "\n".join(lines)


def _ref_key(ref, idx) -> str:
    """Stage-graph node key for an input ref: plan inputs are in<idx>,
    producer stages s<id> (shared by the DOT and SVG renderers)."""
    return f"in{idx}" if ref == "plan_input" else f"s{ref}"


def _stage_exchanges(stage) -> int:
    return sum(1 for op in stage.ops if op.kind in _EXCHANGE_OPS)


def explain_dot(query) -> str:
    """Graphviz DOT of the fused stage graph (the JobBrowser DAG-drawing
    analog, ``JobBrowser/Tools/drawingSurface.cs`` — emitted as DOT so
    any renderer can draw it; exchanges are marked on the node)."""
    from dryad_tpu_torch.plan.lower import lower

    graph = lower([query.node], query.ctx.config, query.ctx.dictionary)
    lines = [
        "digraph stages {",
        "  rankdir=TB; node [shape=box, fontname=\"monospace\", fontsize=10];",
    ]
    inputs = set()
    for s in graph.stages:
        n_ex = _stage_exchanges(s)
        label = s.name + (f"\\n{n_ex} exchange(s)" if n_ex else "")
        style = ', style=filled, fillcolor="#d6eaf8"' if n_ex else ""
        lines.append(f'  s{s.id} [label="{label}"{style}];')
        for ref, idx in s.input_refs:
            if ref == "plan_input":
                if idx not in inputs:
                    inputs.add(idx)
                    lines.append(
                        f'  in{idx} [label="input#{idx}", shape=ellipse];'
                    )
                lines.append(f"  in{idx} -> s{s.id};")
            else:
                lines.append(f'  s{ref} -> s{s.id} [label="out{idx}"];')
    lines.append("}")
    return "\n".join(lines)


def explain(query) -> str:
    """Full explain text for an API ``Query`` (logical + fused stages
    + the whole-DAG fusion regions the executor will dispatch)."""
    from dryad_tpu_torch.plan.lower import lower

    graph = lower([query.node], query.ctx.config, query.ctx.dictionary)
    return (
        explain_logical([query.node])
        + "\n\n" + explain_stages(graph)
        + "\n\n" + explain_fusion(graph, query.ctx.config)
    )


def _layered_layout(graph: StageGraph):
    """Topological layers for the SVG renderer: node -> (layer, column).
    Inputs sit on layer 0; each stage one past its deepest producer."""
    layer: Dict[str, int] = {}
    for s in graph.stages:
        deps = []
        for ref, idx in s.input_refs:
            key = _ref_key(ref, idx)
            if key.startswith("in"):
                layer.setdefault(key, 0)
            deps.append(layer.get(key, 0))
        layer[f"s{s.id}"] = (max(deps) + 1) if deps else 1
    cols: Dict[str, int] = {}
    counts: Dict[int, int] = {}
    for key, ly in layer.items():
        cols[key] = counts.get(ly, 0)
        counts[ly] = counts.get(ly, 0) + 1
    return layer, cols, counts


def explain_svg(query) -> str:
    """Self-contained SVG drawing of the fused stage DAG — the
    JobBrowser drawing surface (``JobBrowser/Tools/drawingSurface.cs``)
    without an external renderer: layered layout, exchange stages
    highlighted, edges as arrows.  Embed in reports or save as .svg."""
    from dryad_tpu_torch.plan.lower import lower

    graph = lower([query.node], query.ctx.config, query.ctx.dictionary)
    layer, cols, counts = _layered_layout(graph)
    BW, BH, GX, GY, PAD = 190, 44, 36, 70, 20
    width = max(counts.values() or [1]) * (BW + GX) + PAD * 2
    height = (max(layer.values() or [0]) + 1) * (BH + GY) + PAD * 2

    def pos(key):
        ly, c = layer[key], cols[key]
        n_in_layer = counts[ly]
        row_w = n_in_layer * BW + (n_in_layer - 1) * GX
        x0 = (width - row_w) / 2 + c * (BW + GX)
        return x0, PAD + ly * (BH + GY)

    def esc(t: str) -> str:
        return (
            t.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
        )

    out = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width:.0f}" '
        f'height="{height:.0f}" font-family="monospace" font-size="11">',
        '<defs><marker id="arr" markerWidth="8" markerHeight="8" '
        'refX="7" refY="3" orient="auto"><path d="M0,0 L8,3 L0,6 z" '
        'fill="#555"/></marker></defs>',
    ]
    # edges first (under the boxes)
    for s in graph.stages:
        x2, y2 = pos(f"s{s.id}")
        for ref, idx in s.input_refs:
            x1, y1 = pos(_ref_key(ref, idx))
            out.append(
                f'<line x1="{x1 + BW/2:.0f}" y1="{y1 + BH:.0f}" '
                f'x2="{x2 + BW/2:.0f}" y2="{y2:.0f}" stroke="#555" '
                'marker-end="url(#arr)"/>'
            )
    for key in layer:
        x, y = pos(key)
        if key.startswith("in"):
            out.append(
                f'<ellipse cx="{x + BW/2:.0f}" cy="{y + BH/2:.0f}" '
                f'rx="{BW/2.4:.0f}" ry="{BH/2:.0f}" fill="#eee" '
                'stroke="#777"/>'
                f'<text x="{x + BW/2:.0f}" y="{y + BH/2 + 4:.0f}" '
                f'text-anchor="middle">input#{esc(key[2:])}</text>'
            )
            continue
        sid = int(key[1:])
        s = next(st for st in graph.stages if st.id == sid)
        n_ex = _stage_exchanges(s)
        fill = "#d6eaf8" if n_ex else "#ffffff"
        name = s.name if len(s.name) <= 26 else s.name[:25] + "…"
        out.append(
            f'<rect x="{x:.0f}" y="{y:.0f}" width="{BW}" height="{BH}" '
            f'rx="6" fill="{fill}" stroke="#333"/>'
            f'<text x="{x + BW/2:.0f}" y="{y + 18:.0f}" '
            f'text-anchor="middle">{esc(name)}</text>'
            f'<text x="{x + BW/2:.0f}" y="{y + 34:.0f}" '
            f'text-anchor="middle" fill="#666">stage {sid}'
            + (f" · {n_ex} exchange(s)" if n_ex else "")
            + "</text>"
        )
    out.append("</svg>")
    return "\n".join(out)


def explain_diagnoses(ctx) -> str:
    """Runtime-health panel for ``Query.explain(analyze=True)``: the
    online pathologies (``obs/diagnose.py``) the context's engine
    caught, plus the phase attribution of the stream it watched."""
    lines = ["== runtime diagnosis =="]
    eng = getattr(ctx, "diagnosis", None)
    if eng is None:
        lines.append("  (diagnosis engine off: config.obs_diagnosis)")
        return "\n".join(lines)
    from dryad_tpu_torch.obs.metrics import JobMetrics

    attr = JobMetrics.from_events(ctx.events.events()).attribution()
    if attr:
        phases = "  ".join(
            f"{k[:-2]}={v:.3f}s"
            for k, v in sorted(attr.items())
            if v and k.endswith("_s")
        )
        if phases:
            lines.append(f"  phases: {phases}")
    found = eng.diagnoses()
    if not found:
        lines.append("  no pathologies detected")
    for d in found:
        ev = " ".join(f"{k}={v}" for k, v in sorted(d["evidence"].items()))
        lines.append(
            f"  [{d['severity']}] {d['rule']} ({d['subject']}): {ev}"
        )
        lines.append(f"      hint: {d['hint']}")
    return "\n".join(lines)


def explain_lint(root=None) -> str:
    """Static-analysis panel: per-rule finding counts and the tree's
    reasoned suppressions, so lint state is visible alongside the
    logical/fusion/SVG panels (and before every card run: the ``lint``
    phase of ``chip_smoke.py`` enforces the same registry)."""
    from dryad_tpu_torch.analysis import engine

    report = engine.run_repo(root=root)
    sup_by_rule: Dict[str, int] = {}
    for f in report.suppressed():
        sup_by_rule[f.rule] = sup_by_rule.get(f.rule, 0) + 1
    counts = report.counts()
    lines = ["== static analysis (graftlint) =="]
    for rule in sorted(set(report.rules_run) | set(counts) | set(sup_by_rule)):
        n = counts.get(rule, 0)
        s = sup_by_rule.get(rule, 0)
        state = f"FINDINGS={n}" if n else "ok"
        extra = f"  suppressed={s}" if s else ""
        lines.append(f"  {rule:<22} {state}{extra}")
    if report.suppressions:
        lines.append(f"  suppressions ({len(report.suppressions)}):")
        for s in report.suppressions:
            lines.append(
                f"    {s.path}:{s.line} [{','.join(s.rules)}] -- {s.reason}"
            )
    lines.append(
        "  tree clean"
        if report.ok
        else f"  TREE DIRTY: {len(report.unsuppressed())} unsuppressed "
        "finding(s) — run python -m dryad_tpu_torch.tools.lint"
    )
    return "\n".join(lines)
