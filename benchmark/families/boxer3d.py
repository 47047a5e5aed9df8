"""BoxeR-3D PointPillars (`boxer_tpu_torch/models/boxer3d.py`) as the
benchmark serves and judges it.

The served call: a batch of voxelized frames handed over from pinned host
memory in f32, with int32 coordinates and point counts, through
`BoxeR3D.forward(..., inference=True)` in the configuration's dtype, then
`dataset/waymo.py:format_for_evalai` on the card: the top `topk` (query,
class) pairs of each frame by score. Scores, labels and metric boxes come
back to the host.

The check: the reference (`reference/boxer3d.py`, f32, the served bf16
weights) runs each judged frame once, following the program's discrete
choices (which encoder proposals the decoder took and which (query, class)
pairs the top-k kept, recorded from the port's calls). Each choice is
judged by how far the reference's own logit of it lies below the
reference's k-th best (`proposal_gap` over every cell's references,
`topk_gap` over the queries' classes, in logits); the returned boxes and
scores against the reference's at the same pairs, each the mean over a
frame's returned pairs: `center_err_m` the distance of a centre (metres),
`size_err_m` the error of a length, width or height (metres),
`heading_err` the heading's (radians, the turn either way), `score_err` a
score's; and `center_err_p95_m`, the 95th percentile of the centres'
distances (a trimmed maximum). Not the maximum itself: on seeded random
weights single boxes of a correct bf16 forward lie up to 10 m from the f32
reference's (`PERF.md` §2), so a maximum cannot tell bf16 from fp8.
"""

import math

import torch

import counts
from counts.boxer3d import boxer3d_forward
from harness import data, lidar, weights

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _build(cls, config, device, seed):
    """The model with the seed's weights, in the served dtype."""
    with torch.device(device):
        model = cls(**config["model"], backbone_cfg=config["backbone"])
    weights.fill_(model, data.substream(seed, "weights"), device,
                  config.get("weight_scales"))
    return model.to(DTYPES[config["dtype"]]).eval()


def _grid(config):
    reader = config["backbone"]["params"]["reader"]
    nx, ny, _ = lidar.grid_of(reader["pc_range"], reader["voxel_size"])
    assert [nx, ny] == config["voxelizer"]["grid"], (nx, ny)
    return nx, ny


def _pinned(arrays, device):
    out = [torch.from_numpy(a) for a in arrays]
    if torch.device(device).type == "cuda":
        out = [t.pin_memory() for t in out]
    return out


class Program:
    def __init__(self, config, traffic, device, seed):
        from boxer_tpu_torch.dataset import waymo
        from boxer_tpu_torch.models.boxer3d import BoxeR3D

        self.config, self.traffic, self.device = config, traffic, device
        self.model = _build(BoxeR3D, config, device, seed)
        self.grid = _grid(config)
        self.pc_range = config["backbone"]["params"]["reader"]["pc_range"]
        b, pool = traffic["batch"], traffic["pool"]
        reader = config["backbone"]["params"]["reader"]
        voxels, coords, npts = _pinned(lidar.frames(
            seed, b * pool, b, traffic["points"], config["voxelizer"],
            reader["pc_range"], reader["voxel_size"]), device)
        n = config["voxelizer"]["max_voxels"]
        self.inputs = [{"voxels": voxels[i * b * n:(i + 1) * b * n],
                        "coordinates": coords[i * b * n:(i + 1) * b * n],
                        "num_points": npts[i * b * n:(i + 1) * b * n]}
                       for i in range(pool)]

        # the program's discrete choices of the last forward, for the check
        self.choices = {}
        tr = self.model.transformer
        proposals = tr._get_enc_proposals

        def record_proposals(*args, **kw):
            out = proposals(*args, **kw)
            self.choices["proposals"] = out[3]
            return out

        tr._get_enc_proposals = record_proposals
        self._waymo, self._top_k = waymo, waymo.top_k

        def record_topk(*args, **kw):
            out = self._top_k(*args, **kw)
            self.choices["topk"] = out[1]
            return out

        waymo.top_k = record_topk
        self._format = waymo.format_for_evalai

    def to_device(self, batch):
        return {k: v.to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def forward(self, batch):
        out = self.model(batch["voxels"], batch["coordinates"],
                         batch["num_points"], self.grid,
                         self.traffic["batch"], inference=True)
        return self._format(out["pred_logits"], out["pred_boxes"],
                            self.pc_range, topk=self.traffic["topk"])

    def to_host(self, out):
        host = {k: out[k].cpu() for k in ("pred_scores", "pred_labels",
                                          "pred_boxes3d")}
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)
        return host

    def keep(self, pool_index, samples, host, out):
        """The judged frames, their results and the choices behind them."""
        c = self.config["model"]["num_classes"]
        batch = self.inputs[pool_index]
        n = self.config["voxelizer"]["max_voxels"]
        recs = []
        for i in samples:
            rows = slice(i * n, (i + 1) * n)
            recs.append({
                "frame": {k: v[rows] for k, v in batch.items()},
                "scores": host["pred_scores"][i],
                "labels": host["pred_labels"][i],
                "boxes": host["pred_boxes3d"][i],
                "proposals": self.choices["proposals"][i].cpu(),
                "q": (self.choices["topk"][i] // c).cpu()})
        return recs

    def flops_per_sample(self) -> int:
        vox = self.config["voxelizer"]
        return counts.total(boxer3d_forward(
            self.config, self.grid, (vox["max_voxels"], vox["max_points"])))

    def free(self):
        self._waymo.top_k = self._top_k
        del self.model
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()


def reference(config, device, seed, control=False):
    """The f32 reference on the served weights; with control, the same
    computed in fp8 (`reference/control.py`)."""
    from reference.boxer3d import BoxeR3D
    from reference.control import to_fp8

    model = _build(BoxeR3D, config, device, seed).float()
    return to_fp8(model) if control else model


def _inputs(rec, device):
    """The judged frame, as the program got it, as a batch of one."""
    f = rec["frame"]
    coords = f["coordinates"].to(device).clone()
    coords[:, 0] = torch.where(coords[:, 0] >= 0, 0, -1)
    return (f["voxels"].to(device), coords, f["num_points"].to(device))


def _kth_gap(scores, chosen, k):
    """How far the chosen entries of `scores` lie below its k-th best."""
    flat = scores.float().reshape(-1)
    kth = torch.topk(flat, k).values[-1]
    return float((kth - flat[chosen]).clamp(min=0).max())


def _judge_one(ref, rec, inputs, grid, topk):
    """The numbers of one judged frame (module docstring)."""
    dev = inputs[0].device
    tr = ref.transformer
    q, labels = rec["q"].to(dev), rec["labels"].to(dev)
    tr.forced = {"proposals": rec["proposals"][None].to(dev),
                 "topk": (q[None], labels[None])}
    tr.seen = {}
    out = ref(*inputs, grid, 1, topk)
    got = {"proposal_gap": _kth_gap(tr.seen["proposals"][1][0],
                                    rec["proposals"].to(dev),
                                    rec["proposals"].numel())}
    cls = tr.seen["topk"][1][0]                               # (NQ, C)
    got["topk_gap"] = _kth_gap(cls, q * cls.shape[-1] + labels, q.numel())
    mine, theirs = rec["boxes"].float(), out["boxes"][0].cpu()
    turn = torch.remainder(mine[:, 6] - theirs[:, 6] + math.pi, 2 * math.pi)
    dist = (mine[:, :3] - theirs[:, :3]).norm(dim=-1)
    got["center_err_m"] = float(dist.mean())
    got["center_err_p95_m"] = float(torch.quantile(dist, 0.95))
    got["size_err_m"] = float((mine[:, 3:6] - theirs[:, 3:6]).abs().mean())
    got["heading_err"] = float((turn - math.pi).abs().mean())
    got["score_err"] = float((rec["scores"].float()
                              - out["scores"][0].cpu()).abs().mean())
    return got


def judge(config, traffic, device, seed, records) -> dict:
    """The largest of each number over the judged frames."""
    if not records:
        return {}
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = reference(config, device, seed)
        worst = {}
        with torch.no_grad():
            for rec in records:
                got = _judge_one(ref, rec, _inputs(rec, device),
                                 _grid(config), traffic["topk"])
                for k, v in got.items():
                    worst[k] = max(worst.get(k, 0.0), v)
        return worst
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev


def control_records(config, traffic, device, seed, records) -> list:
    """The control in the program's place: the fp8 reference's own results
    and choices on the judged frames, in the form `keep` gives."""
    ctl = reference(config, device, seed, control=True)
    out_recs = []
    with torch.no_grad():
        for rec in records:
            ctl.transformer.forced, ctl.transformer.seen = {}, {}
            out = ctl(*_inputs(rec, device), _grid(config), 1,
                      traffic["topk"])
            seen = ctl.transformer.seen
            out_recs.append({
                "frame": rec["frame"], "scores": out["scores"][0].cpu(),
                "labels": out["labels"][0].cpu(),
                "boxes": out["boxes"][0].cpu(),
                "proposals": seen["proposals"][0][0].cpu(),
                "q": seen["topk"][0][0][0].cpu()})
    return out_recs

