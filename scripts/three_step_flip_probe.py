"""Where the full-graph (K2) and frontier (K3) train steps part, on one
card:

    python scripts/three_step_flip_probe.py [--work DIR]

It builds the 100k-track synthetic catalog and trains it briefly as
``chip_smoke.py`` does (``run_main_path``, ``run_train_path``), then takes
the trainer's seeded init and ``chip_smoke.py`` ``three_step_checks``'
first batch, and prints:

* for the deepest conv of that step, how many of its entries' leaky_relu
  slopes differ from float64's in K3's slope residual, in K2's projected
  table and in one f32 ``addmm``, with the largest |pre| among them in
  float64, and how many differ between K3 and K2 (0: one 3xTF32
  product);
* the step-1 loss of both paths and, for every leaf, the largest
  difference of the two paths' gradients beside the largest gradient.

Those gradients differ in the order of their sums only; where one is ~0
in one path and ~1e-11 in the other, Adam's eps turns it into a ~1e-6
update, which is how the two paths' 3-step runs come to differ in the
deepest Wq.  The probe measures the package of the checkout it lies in.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--work", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "build", "three_step_flip_probe"))
    args = parser.parse_args(argv)

    import torch

    import chip_smoke as cs
    from gcn_song_embeddings_tpu_torch.data.device import DeviceGraph
    from gcn_song_embeddings_tpu_torch.models.pinsage import init_pinsage
    from gcn_song_embeddings_tpu_torch.ops import agg
    from gcn_song_embeddings_tpu_torch.ops.ppr import block_generator
    from gcn_song_embeddings_tpu_torch.train.trainer import (
        PinSageTrainer,
        make_optimizer,
        triple_loss,
    )

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # as chip_smoke.py runs
    torch.backends.cudnn.allow_tf32 = False
    st = cs.run_main_path(dev, args.work)
    tr_st = cs.run_train_path(dev, st, args.work)
    graph = st.graph
    trainer = PinSageTrainer(DeviceGraph.from_graph(graph, dev),
                             graph.n_items, graph.features, st.train_pos,
                             cfg=tr_st.cfg,
                             base_run_dir=os.path.dirname(tr_st.run_dir),
                             nbhds_path=graph.nbhds_path, log=False,
                             load_save=True, verbose=False)
    tcfg, mcfg = trainer.cfg.train, trainer.cfg.model
    batch = trainer.sample(block_generator(12345, 0, dev))
    seeded = torch.Generator(device=dev)
    seeded.manual_seed(tcfg.seed)
    init = init_pinsage(seeded, mcfg.n_layers, mcfg.in_dim, mcfg.hidden_dim,
                        mcfg.out_dim, mcfg.bias_init)
    trainer.params = copy.deepcopy(init)

    layer, table, ids, wts, _ = cs.step_conv_inputs(torch, trainer,
                                                    batch)[0]
    Wq, bq = layer.Wq.detach(), layer.bq.detach()
    flat = ids.reshape(-1).long()
    with torch.no_grad():
        k3 = agg.conv_aggregate_slopes(table, ids, wts, Wq, bq, "dma")
        k2 = agg.conv_aggregate_slopes(table, ids, wts, Wq, bq, "stream")
        pre64 = torch.addmm(bq.double(), table.double(),
                            Wq.double().t())[flat]
        addmm = torch.addmm(bq, table, Wq.t())[flat] >= 0
    for name, slope in (("K3 residual", k3), ("K2 residual", k2),
                        ("f32 addmm", addmm)):
        differ = slope != (pre64 >= 0)
        print(f"{name} vs float64: {int(differ.sum())} of {differ.numel()} "
              f"slopes differ, max |pre| among them "
              f"{float(pre64[differ].abs().max()) if differ.any() else 0}",
              flush=True)
    print(f"K3 vs K2 residual: {int((k3 != k2).sum())} slopes differ",
          flush=True)
    del k3, k2, pre64, addmm

    def grads(fullgraph):
        params = copy.deepcopy(init)
        opt = make_optimizer(params, tcfg)
        loss, _ = triple_loss(params, trainer.tables, batch, tcfg, mcfg,
                              fullgraph)
        names = [name for name, _ in params.leaves()]
        return (dict(zip(names, torch.autograd.grad(loss, opt.params))),
                float(loss.detach()))

    g_on, loss_on = grads(True)
    g_off, loss_off = grads(False)
    print(f"step-1 loss: full graph {loss_on!r}, frontier {loss_off!r}",
          flush=True)
    for name in g_on:
        print(f"gradient {name}: max |full graph - frontier| "
              f"{float((g_on[name] - g_off[name]).abs().max())!r}, max "
              f"|frontier| {float(g_off[name].abs().max())!r}", flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
