"""The paper's headline scenario: place GPT-3 / Swin / AlphaFold2 across a
heterogeneous 4-GPU cluster and compare all four algorithms, inter-server vs
intra-server, original vs coarsened (Fig. 10 in miniature).

    PYTHONPATH=src python -m repro_torch.examples.heterogeneous_placement
    PYTHONPATH=src python -m repro_torch.examples.heterogeneous_placement \
        --device cpu

placeto's REINFORCE policy trains on ``--device`` (the first card by
default); the other planners run on the host.
"""

from __future__ import annotations

import argparse

from repro_torch.core import CostModel, plan
from repro_torch.core.devices import inter_server_cluster, intra_server_cluster
from repro_torch.core.fusion import DEFAULT_RULES
from repro_torch.core.modelgraph import paper_graph
from repro_torch.core.simulate import evaluate
from repro_torch.examples import add_device_flag, devices_for

MODELS = ("gpt3-330m", "swin-1.8b", "af2-87m")
METHODS = ("placeto", "msct", "getf", "moirai")


def run(clusters=None, models=MODELS, methods=METHODS, *, time_limit=20,
        placeto_iters=40, placeto_device=None) -> dict:
    """A line a (cluster, model), printed as the reference prints it;
    returns ``{(cluster name, model): {method: (plan, makespan s)}}``."""
    rows = {}
    for cluster in clusters or (inter_server_cluster(), intra_server_cluster()):
        cm = CostModel(cluster)
        print(f"\n=== {cluster.name} ===")
        for model in models:
            g = paper_graph(model)
            line = [f"{model:10s}"]
            base = None
            row = rows[(cluster.name, model)] = {}
            for method in methods:
                res = plan(
                    g, cluster, method=method, coarsen=True,
                    time_limit=time_limit, mip_rel_gap=0.05, placeto_iters=placeto_iters,
                    placeto_device=placeto_device,
                )
                mk = evaluate(g, res.placement, cm, runtime_fusion_rules=DEFAULT_RULES)
                if method == "placeto":
                    base = mk
                line.append(f"{method}={mk*1e3:8.2f}ms")
                row[method] = (res, mk)
            if base is not None:
                line.append(f"speedup_vs_placeto={base/mk:.2f}x")
            print("  ".join(line))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_flag(ap)
    args = ap.parse_args(argv)
    return run(placeto_device=devices_for(args.device)[0])


if __name__ == "__main__":
    main()
