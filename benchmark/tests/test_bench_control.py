"""The check that decides `correct` must fail what it exists to catch: the
control (the reference in fp8 in the program's place) at a size the CPU
holds, and a run whose timed path is broken underneath, driven by the
harness past its look for a card."""

import json

import pytest
import torch
from conftest import SMALL_LIMITS, run_cell

from harness import spec


def _readings(bench_json, cell_name, seed, control):
    import run

    cell = spec.load_cell(bench_json, cell_name, bench_json.parent / "benchmark")
    family = spec.load_module("families", cell.config["family"])
    driver = spec.load_module("drivers", cell.traffic["driver"])
    out = driver.run(cell, family, seed, 0.3, False, "cpu", 0.0,
                     run.CACHE / "scratch")
    recs = out["records"]
    if control:
        recs = family.control_records(cell.config, cell.traffic, "cpu", seed,
                                      recs)
    return family.judge(cell.config, cell.traffic, "cpu", seed, recs)


def test_control_fails_and_program_passes(small_bench):
    limits = SMALL_LIMITS["tiny2d"]
    for seed in (101, 2 ** 31 + 3):
        prog = _readings(small_bench, "tiny2d.infer", seed, control=False)
        ctl = _readings(small_bench, "tiny2d.infer", seed, control=True)
        assert all(prog[k] <= lim for k, lim in limits.items()), prog
        assert any(ctl[k] > lim for k, lim in limits.items()), ctl


def _run_broken(small_bench, cell, capsys):
    rc, res = run_cell(small_bench, cell, capsys=capsys)
    assert rc == 0
    return res


def test_an_altered_answer_fails(small_bench, capsys, monkeypatch):
    """A label changed where the postprocess makes it."""
    from boxer_tpu_torch.nn import box_transformer

    real = box_transformer.select_topk

    def altered(*args, **kw):
        scores, labels, q, xy = real(*args, **kw)
        labels = labels.clone()
        labels[:, 3] = (labels[:, 3] + 1) % 91
        return scores, labels, q, xy

    monkeypatch.setattr(box_transformer, "select_topk", altered)
    res = _run_broken(small_bench, "tiny2d.infer", capsys)
    assert res["correct"] is False
    assert res["check"]["topk_gap"]["value"] > res["check"]["topk_gap"]["limit"]


def test_an_altered_mask_fails(small_bench, capsys, monkeypatch):
    """A mask pixel flipped where the paste makes it."""
    from boxer_tpu_torch.nn import box_transformer

    real = box_transformer.paste_and_rescore

    def altered(*args, **kw):
        scores, masks = real(*args, **kw)
        masks = masks.clone()
        masks[:, 2, 10, 10] = ~masks[:, 2, 10, 10]
        return scores, masks

    monkeypatch.setattr(box_transformer, "paste_and_rescore", altered)
    res = _run_broken(small_bench, "tiny2d.infer", capsys)
    assert res["correct"] is False
    assert res["check"]["mask_paste_err"]["value"] >= 1


def test_half_the_batch_left_out_fails(small_bench, capsys, monkeypatch):
    """The forward runs the first half of the batch in place of the whole:
    the second half's images never reach the model."""
    from boxer_tpu_torch.models.boxer2d import BoxeR2D

    real = BoxeR2D.forward

    def half(self, image, mask=None, **kw):
        n = image.shape[0] // 2
        return real(self, torch.cat([image[:n], image[:n]]), mask, **kw)

    monkeypatch.setattr(BoxeR2D, "forward", half)
    res = _run_broken(small_bench, "tiny2d.infer", capsys)
    assert res["correct"] is False


def test_the_limits_are_in_the_result(small_bench, capsys):
    rc, res = run_cell(small_bench, "tiny2d.infer", capsys=capsys)
    assert rc == 0 and res["correct"] is True
    assert set(res["check"]) == set(SMALL_LIMITS["tiny2d"])
    assert json.dumps(res).endswith("}}}")


@pytest.mark.gpu
def test_cells_run_correct_on_the_card(capsys):
    """Each cell of BENCHMARK.json, a short window on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import run
    from conftest import ROOT

    for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]:
        rc = run.main(["--workload", w["name"], "--seed", "77", "--seconds",
                       "2", "--trace", "0"])
        res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 0 and res["correct"] is True, res["check"]
