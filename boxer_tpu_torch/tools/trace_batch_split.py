"""Trace phase 12a's world-2 against world-1 gap: a batch-2 train step
against the same two images as two microbatches of one in this process,
then as two ranks in two processes, on the first CUDA card.

    PYTHONPATH=. python boxer_tpu_torch/tools/trace_batch_split.py

Run from the root of a checkout (the ranks import this module and
`chip_smoke.py` by name). The setup is `chip_smoke.py`'s phase 12a: the
shipped segm config through the trainer with `DP_F32_CUTS` (R50 at full
width with the trainer's seeded weights, f32, no TF32, no autocast,
256x384), the same two synthetic images with 20 targets each, and the
pre-clip gradients of one step (`debug_grads`):

1. in this process, a batch of 2 (A=1, B=2) against the same images as 2
   microbatches of 1 (A=2, B=1: summed under one `num_boxes`, what two
   ranks sum): the worst and median gradient leaf, whether the encoder's
   proposals are equal, and the training forward (no autograd) module by
   module, the batch-2 output against the two batch-1 outputs stacked on
   the batch axis (outputs whose batch axis is not their leading one are
   skipped);
2. two ranks sharing the card over gloo (`parallel/distributed.py:
   launch`, as phase 12a runs them), each with its image at B=1: each
   rank's training forward module by module against this process's
   batch-1 forward of the same image, and the ranks' summed gradients
   against step 1's two microbatches.

For each comparison it prints the first module whose output passes rel
err 1e-5 and 1e-3, and the worst leaf with its scale (its largest entry
over the largest gradient entry). Phase 12a compares the parameter
updates, each taken as the updated f32 parameters less the weights; so
it also prints, leaf by leaf, the f32 spacing of the weights over the
largest entry of the first SGD update (the group's LR x the clip's factor
x the gradient), the largest rel err that rounding the parameters alone
gives, and the leaves where that is largest. One JSON line last.
"""

import json
import sys
import tempfile
from pathlib import Path

import torch


def _tensors(out):
    if torch.is_tensor(out):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    if isinstance(out, dict):
        return [t for o in out.values() for t in _tensors(o)]
    return []


def _forward_outputs(model, image, mask):
    """The training forward without autograd: every module's tensor
    outputs on the host, in call order."""
    kept = []
    hooks = [mod.register_forward_hook(
        lambda m, i, o, name=name: kept.append(
            (name, [t.detach().float().cpu() for t in _tensors(o)])))
        for name, mod in model.named_modules() if name]
    with torch.no_grad():
        model(image, mask, train=True, inference=False)
    for h in hooks:
        h.remove()
    return kept


def _first_beyond(pairs):
    """pairs: (name, got outputs, want outputs) in call order -> ({tol:
    (name, output, err)} for 1e-5 and 1e-3, the largest err)."""
    import chip_smoke as cs

    firsts, largest = {}, 0.0
    for name, got, want in pairs:
        for k, (g, w) in enumerate(zip(got, want)):
            if g.shape != w.shape or g.dim() == 0:
                continue
            err = cs.rel_err(g, w)
            largest = max(largest, err)
            for tol in (1e-5, 1e-3):
                if err > tol and tol not in firsts:
                    firsts[tol] = (name, k, err)
    return firsts, largest


def _setup(root):
    import chip_smoke as cs

    return cs.trainer_on_card(root, cs.DP_F32_CUTS + [
        f"training.save_dir={root}/save"])


def _debug_step(trainer):
    from boxer_tpu_torch.parallel.steps import make_train_step

    return make_train_step(trainer.criterion, max_norm=0.1,
                           compute_dtype=torch.float32, debug_grads=True)


def rank_trace(task_path):
    """One of the two ranks: its image's training forward module by
    module, then one step's pre-clip gradients (summed over the ranks)."""
    import chip_smoke as cs
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    task = torch.load(task_path, weights_only=False)
    rank = dist.get_rank()
    trainer = _setup(Path(task["root"]))
    batch = cs.tree_map(task["batch"], lambda t: t[:, rank:rank + 1].to(
        trainer.device))
    forward = _forward_outputs(trainer.state.model, batch["image"][0],
                               batch["mask"][0])
    _, stats = _debug_step(trainer)(trainer.state, batch)
    torch.save({"forward": forward,
                "grads": {n: g.cpu() for n, g in stats["_grads"].items()}},
               Path(task["out"]) / f"rank{rank}.pt")


def _worst_leaf(got, want):
    """(worst rel err, its leaf, the leaf's scale, median) of got's
    gradient leaves against want's."""
    import chip_smoke as cs

    errs = {n: cs.rel_err(got[n], g) for n, g in want.items()}
    leaf = max(errs, key=errs.get)
    scale = float(want[leaf].abs().max()) / max(
        float(g.abs().max()) for g in want.values())
    return (errs[leaf], leaf, scale,
            float(torch.tensor(list(errs.values())).median()))


def main():
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs
    from boxer_tpu_torch.dataset.synthetic import synthetic_batch
    from boxer_tpu_torch.ops import _build
    from boxer_tpu_torch.parallel.distributed import launch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    _build.library()
    dev = torch.device("cuda", 0)
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    cs.write_coco(root)
    host = synthetic_batch(2, *cs.E2E_CANVAS, num_targets=20,
                           num_classes=_setup(root).num_classes,
                           with_masks=True, seed=1, iter_per_update=1)
    batch = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
                 if isinstance(v, dict) else torch.from_numpy(v))
             for k, v in host.items()}

    def on_card(split):
        def put(t):
            t = t.to(dev)
            return t.reshape((2, 1) + t.shape[2:]) if split else t
        return cs.tree_map(batch, put)

    # 1. one process: batch 2 against 2 microbatches of 1
    grads, proposals = {}, {}
    for split in (False, True):
        trainer = _setup(root)
        weights = {n: p.detach().clone() for n, p in
                   trainer.state.model.named_parameters()}
        lrs = {id(p): g["lr"] for g in trainer.state.optimizer.param_groups
               for p in g["params"]}
        lr = {n: lrs[id(p)] for n, p in
              trainer.state.model.named_parameters()}
        choose = trainer.state.model.transformer._get_enc_proposals
        proposals[split] = []

        def spy(*args):
            out = choose(*args)
            proposals[split].append(out[3].clone())
            return out

        trainer.state.model.transformer._get_enc_proposals = spy
        _, stats = _debug_step(trainer)(trainer.state, on_card(split))
        grads[split] = {n: g.cpu() for n, g in stats["_grads"].items()}
        del trainer, stats
        torch.cuda.empty_cache()
    one = _worst_leaf(grads[True], grads[False])
    norm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                for g in grads[False].values())))
    clip = min(1.0, 0.1 / (norm + 1e-6))
    rounding = {}
    for n, g in grads[False].items():
        if not bool(g.abs().max() > 0):
            continue
        w = weights[n].cpu()
        spacing = (torch.nextafter(w, torch.full_like(w, float("inf")))
                   - w).max()
        rounding[n] = float(spacing) / (lr[n] * clip * float(g.abs().max()))
    top = sorted(rounding, key=rounding.get, reverse=True)[:5]
    print("the parameters' f32 rounding over the first update's largest "
          "entry, by leaf (the rel err rounding alone can give 12a): "
          + ", ".join(f"{n} {rounding[n]:.3e}" for n in top))
    same_props = torch.equal(torch.cat(proposals[True][:2]),
                             proposals[False][0])
    model = _setup(root).state.model.train()
    split, whole = on_card(True), on_card(False)
    singles = [_forward_outputs(model, split["image"][i], split["mask"][i])
               for i in range(2)]
    both = _forward_outputs(model, whole["image"][0], whole["mask"][0])
    in_process, largest = _first_beyond(
        (n, [torch.cat([a, b]) for a, b in zip(a0, b0)],
         [w for w in outs if w.dim() and w.shape[0] == 2])
        for (n, a0), (_, b0), (_, outs) in zip(*singles, both))
    del model, both
    torch.cuda.empty_cache()
    print(f"1. one process, 2 x 1 against 1 x 2: worst leaf {one[0]:.3e} "
          f"({one[1]}, scale {one[2]:.3e}), median {one[3]:.3e}; proposals "
          f"equal {same_props}; module outputs: largest rel err "
          f"{largest:.3e}, first beyond 1e-5 / 1e-3 {in_process}")

    # 2. two ranks in two processes sharing the card over gloo
    out = root / "ranks"
    out.mkdir()
    task = root / "task.pt"
    torch.save(dict(root=str(root), out=str(out), batch=batch), task)
    launch(rank_trace, 2, "gloo", args=(str(task),), devices=[0, 0],
           timeout=900)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    fwd = {}
    for r in range(2):
        fwd[r] = _first_beyond((n, got, want) for (n, got), (_, want) in
                               zip(ranks[r]["forward"], singles[r]))
        print(f"2. rank {r} (its own process) against this process's "
              f"batch-1 forward of the same image: largest rel err "
              f"{fwd[r][1]:.3e}, first beyond 1e-5 / 1e-3 {fwd[r][0]}")
    two = _worst_leaf(ranks[0]["grads"], grads[True])
    print(f"2. the ranks' summed gradients against one process's 2 x 1: "
          f"worst leaf {two[0]:.3e} ({two[1]}, scale {two[2]:.3e}), median "
          f"{two[3]:.3e}")
    print(json.dumps({
        "rounding": {n: rounding[n] for n in top},
        "one_process": {"worst_leaf": one[0], "leaf": one[1],
                        "scale": one[2], "median": one[3],
                        "proposals_equal": same_props,
                        "largest_output_err": largest,
                        "first": {str(t): v for t, v in in_process.items()}},
        "ranks": {"worst_leaf": two[0], "leaf": two[1], "scale": two[2],
                  "median": two[3],
                  "forward": {r: {"largest": v[1], "first": {
                      str(t): x for t, x in v[0].items()}}
                      for r, v in fwd.items()}}}))
    tmp.cleanup()


if __name__ == "__main__":
    main()
