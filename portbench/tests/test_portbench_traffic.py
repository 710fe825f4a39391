"""The traffic generator: reproducible from the seed, the same work for
every seed, batches as the trainer takes them."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import traffic
from portbench.tests.tiny import tiny_files

ROOT = Path(__file__).resolve().parents[2]


def _cohort(seed):
    _, cfg, mix, _ = tiny_files()
    return traffic.Cohort(cfg, mix, seed, torch.device("cpu")), mix


def test_same_seed_same_traffic_other_seed_same_work():
    a, _ = _cohort(2**31 + 17)
    b, _ = _cohort(2**31 + 17)
    c, _ = _cohort(5)
    for x, y in ((a.lengths, b.lengths), (a.omic, b.omic), (a.y_disc, b.y_disc)):
        assert np.array_equal(x, y)
    assert all(torch.equal(x, y) for x, y in zip(a.arena, b.arena))
    assert not np.array_equal(a.omic, c.omic) and not np.array_equal(a.y_disc, c.y_disc)
    assert not torch.equal(a.arena[0], c.arena[0])
    assert np.array_equal(a.lengths, c.lengths)  # the same work for every seed


def test_lengths_fill_the_buckets_evenly():
    _, cfg, mix, _ = tiny_files()
    full = dict(mix, bag_patches={"min": 1024, "max": 8192, "distribution": "log_uniform"})
    lengths = traffic.bag_lengths(999, full)
    assert lengths.min() >= 1024 and lengths.max() <= 8192
    counts = np.histogram(lengths, bins=[0, 2048, 4096, 8192])[0]
    assert np.all(np.abs(counts - 333) <= 2)


def test_fold_mix_lengths_follow_the_full_scale_runs_bags():
    """The fold mix's stratified lengths against random draws made as
    scripts/gen_dress_data.py makes the full-scale run's bags."""
    mix = json.loads((ROOT / "portbench" / "traffic" / "fold_1k-8k.json").read_text())
    lengths = traffic.bag_lengths(1000, mix)
    draws = np.clip(np.random.default_rng(20260816).lognormal(np.log(2800), 0.55, 200_000),
                    1000, 8192).astype(int)
    bins = [0, 2048, 4096, 8192]
    share = np.histogram(lengths, bins)[0] / lengths.size
    assert np.allclose(share, np.histogram(draws, bins)[0] / draws.size, atol=0.01)
    assert abs(lengths.mean() / draws.mean() - 1) < 0.01
    assert lengths.min() == 1000 and lengths.max() == 8192


def test_arena_layout_and_batches():
    cohort, mix = _cohort(3)
    data, scale = cohort.arena
    tail = int(cohort.lengths.sum())
    assert data.shape[0] == tail + mix["bag_patches"]["max"]
    assert not data[tail:].any() and not scale[tail:].any()
    split = traffic.ArenaSplit(cohort, np.arange(cohort.n))
    batches = list(split.iter_batches(4, shuffle=True, rng=np.random.default_rng(0),
                                      bucket_boundaries=mix["bucket_boundaries"]))
    assert len(batches) == split.count_batches(None, 4, mix["bucket_boundaries"])
    assert sum(int(b["sample_mask"].sum()) for b in batches) == cohort.n
    for b in batches:
        width = b["kv_masks"][-1].shape[1]
        assert width in mix["bucket_boundaries"]
        assert np.all(b["patch_lengths"] <= width)
        assert np.array_equal(b["kv_masks"][-1].sum(1), b["patch_lengths"])


def test_check_batches_are_distinct_and_cover_each_bucket_in_rounds():
    cohort, mix = _cohort(4)
    train, _, _ = traffic.train_val_test_split(cohort.n, seed=1)
    batches = traffic.check_batches(cohort, train, mix, seed=4)
    spec = mix["check"]
    offsets = np.concatenate([b["patch_offsets"] for b in batches])
    assert len(set(offsets.tolist())) == len(offsets) == 4 * mix["batch_size"]
    widths = [b["kv_masks"][-1].shape[1] for b in batches]
    assert widths == spec["buckets"] * spec["rounds"]
    assert set(train.tolist()) >= {int(np.flatnonzero(cohort.offsets == o)[0]) for o in offsets}


def test_streamed_batches_carry_the_dequantized_bags():
    _, cfg, mix, _ = tiny_files(arena="none")
    cohort = traffic.Cohort(cfg, mix, 6, torch.device("cpu"))
    hb = cohort.batch([0, 1, 2], 64, 4)
    assert "patch_offsets" not in hb and hb["tensors"][1].dtype == np.float16
    ref = cohort.arena_batch([0, 1, 2], 64, 4)
    _, values, scales, mask = cohort.gather(ref)
    want = (values.float() * scales[..., None]).half().numpy()
    assert np.array_equal(hb["tensors"][1], want)
    assert np.array_equal(hb["kv_masks"][-1], mask.numpy())


def test_split_is_the_pipelines():
    tr, te, va = traffic.train_val_test_split(1000, seed=3)
    assert (len(tr), len(te), len(va)) == (700, 150, 150)
    assert np.array_equal(np.sort(np.concatenate([tr, te, va])), np.arange(1000))
    assert traffic.class_weights(np.array([0, 0, 1]), 4) == pytest.approx([0.5, 1.0, 1.0, 1.0])
