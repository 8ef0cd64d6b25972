"""PageRank via DoWhile (``samples/pagerank_dowhile.py``): iteration
with a join inside the loop body.  The loop state is {node, rank, prev};
each round joins ranks onto the edge list, sums contributions per
destination, applies the damping factor, and the condition keeps
iterating while max |rank - prev| > eps.

Run:
    python -m dryad_tpu_torch.samples.pagerank_dowhile [--device cpu]
"""

import numpy as np

from dryad_tpu_torch import DryadContext
from dryad_tpu_torch.samples import parser

DAMP, EPS = 0.85, 1e-4
N_NODES = 64


# Module-level row functions: the driver re-evaluates the body every
# round and builds each subplan once per function object.
def _contrib_row(c):
    return {"node": c["dst"], "c": c["w"] * c["rank"]}


def _apply_rank(c):
    return {
        "node": c["node"],
        "rank": (1.0 - DAMP) / N_NODES + DAMP * c["inflow"],
        "prev": c["rank"],
    }


def _delta_row(c):
    return {"d": abs(c["rank"] - c["prev"])}


def _go_row(c):
    return {"go": c["m"] > EPS}


def main(argv=None) -> None:
    args = parser(__doc__).parse_args(argv)
    rng = np.random.default_rng(7)
    n_nodes, n_edges = N_NODES, 400
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    deg = np.bincount(src, minlength=n_nodes).astype(np.float32)

    ctx = DryadContext(num_partitions_=8, device=args.device)
    edges = ctx.from_arrays(
        {
            "src": src,
            "dst": dst,
            "w": (1.0 / np.maximum(deg, 1.0))[src].astype(np.float32),
        }
    ).cache()
    nodes = np.arange(n_nodes, dtype=np.int32)
    state = ctx.from_arrays(
        {
            "node": nodes,
            "rank": np.full(n_nodes, 1.0 / n_nodes, np.float32),
            "prev": np.zeros(n_nodes, np.float32),
        }
    )

    def body(q):
        contrib = (
            edges.join(q, "src", "node")
            .select(_contrib_row)
            .group_by("node", {"inflow": ("sum", "c")})
        )
        return q.left_join(contrib, "node").select(_apply_rank)

    def cond(q):
        return (
            q.select(_delta_row)
            .aggregate_as_query({"m": ("max", "d")})
            .select(_go_row)
        )

    out = state.do_while(body, cond, max_iter=50).order_by([("rank", True)]).collect()
    total = float(np.sum(out["rank"]))
    print(f"converged: {len(out['node'])} nodes, total rank {total:.4f}")
    for i in range(5):
        print(f"  #{i + 1}: node {int(out['node'][i])} rank {out['rank'][i]:.5f}")

    # numpy oracle
    r = np.full(n_nodes, 1.0 / n_nodes, np.float64)
    w = (1.0 / np.maximum(deg, 1.0))[src]
    for _ in range(200):
        inflow = np.zeros(n_nodes)
        np.add.at(inflow, dst, w * r[src])
        nr = (1.0 - DAMP) / n_nodes + DAMP * inflow
        if np.max(np.abs(nr - r)) <= EPS / 10:
            break
        r = nr
    order = np.argsort(-r)
    assert int(out["node"][0]) == int(order[0]), (out["node"][0], order[0])
    print("top node matches numpy PageRank: OK")


if __name__ == "__main__":
    main()
