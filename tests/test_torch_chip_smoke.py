"""``chip_smoke.py``'s arithmetic, on the CPU: the training step's
operation count that its MFU lines divide by, against hand counts; the
dry run's peaks that it prints, against ``tools/zoo_train_peaks.py``;
and the fingerprint of a state tree that its training paths compare."""
import dataclasses
import pathlib
import sys

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.device_plugin import flatten_with_paths
from repro_torch.models.lm import LM

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

sys.path.insert(0, str(ROOT / "tools"))

import zoo_train_peaks  # noqa: E402


def _params(cfg) -> int:
    model = LM(cfg, device="cpu")
    return sum(t.numel() for t in flatten_with_paths(
        model.init_abstract()).values())


def test_train_flops_counts_the_routed_experts_only():
    """qwen3-moe-30b-a3b at 2 of 48 layers, B 4 x 512: a token runs the
    attention projections, the q/k and block norms, the router, 8 of the
    128 experts and the untied head; the embedding table is a gather.
    Attention: all causal pairs."""
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"), num_layers=2)
    d, H, KV, hd, V = 2048, 32, 4, 128, 152064
    E, k, f, B, S = 128, 8, 768, 4, 512
    layer = (d * H * hd + 2 * d * KV * hd + H * hd * d   # q, k, v, o
             + 2 * hd + 2 * d                          # q/k and block norms
             + d * E + k * 3 * d * f)                  # router, 8 experts
    used = 2 * layer + d + d * V                       # final norm, head
    n = _params(cfg)
    assert n - used == V * d + 2 * (E - k) * 3 * d * f
    attn = 2 * 3 * 4 * B * H * hd * (S * (S + 1) // 2)
    assert chip_smoke.train_flops(cfg, n, B, S) == 6 * used * B * S + attn
    # the whole-param count overstated the step by 2.5x and more
    assert 6 * n * B * S / (6 * used * B * S + attn) > 2.5


def test_train_flops_counts_the_window_visible_pairs_only():
    """h2o-danube-1.8b at 2 of 24 layers, B 1 x 4608: each query sees at
    most the 4096 keys of its window, so the last 512 queries see 4096
    each; the untied embedding is a gather."""
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b"), num_layers=2)
    d, H, hd, V, W, B, S = 2560, 32, 80, 32000, 4096, 1, 4608
    visible = W * (W + 1) // 2 + (S - W) * W
    assert visible == sum(min(q + 1, W) for q in range(S))
    n = _params(cfg)
    want = 6 * (n - V * d) * B * S + 2 * 3 * 4 * B * H * hd * visible
    assert chip_smoke.train_flops(cfg, n, B, S) == want


@pytest.mark.parametrize("S,window,want", [(5, 0, 15), (5, 8, 15),
                                           (5, 2, 9), (1, 1, 1)])
def test_visible_pairs(S, window, want):
    assert chip_smoke.visible_pairs(S, window) == want
    assert want == sum(min(q + 1, window or S) for q in range(S))


def test_train_flops_counts_an_untied_head_but_not_its_embedding():
    """phi3-medium-14b at 2 of 40 layers, B 4 x 512: a token runs the
    attention projections (40 query heads over 10), the block norms,
    the SwiGLU MLP and the untied 100352-row head's product; the
    embedding table beside it is a gather.  Attention: all causal
    pairs."""
    cfg = dataclasses.replace(get_config("phi3-medium-14b"), num_layers=2)
    d, H, KV, hd, f, V, B, S = 5120, 40, 10, 128, 17920, 100352, 4, 512
    layer = (d * H * hd + 2 * d * KV * hd + H * hd * d   # q, k, v, o
             + 3 * d * f                               # gate, up, down
             + 2 * d)                                  # block norms
    used = 2 * layer + d + d * V                       # final norm, head
    n = _params(cfg)
    assert n == 1_709_204_480 and n - used == V * d
    attn = 2 * 3 * 4 * B * H * hd * (S * (S + 1) // 2)
    assert chip_smoke.train_flops(cfg, n, B, S) == 6 * used * B * S + attn
    # 14.754 TFLOP a step; the embedding would add 6.3 more
    assert round(chip_smoke.train_flops(cfg, n, B, S) / 1e12, 3) == 14.754


def test_train_flops_of_a_tied_dense_model_is_unchanged():
    """qwen1.5-0.5b (tied embedding, no window): 6 per param per token
    plus all causal pairs, the count phase 3's MFU has always used."""
    cfg = get_config("qwen1.5-0.5b")
    n, B, S = _params(cfg), 4, 512
    attn = 3 * 4.0 * B * cfg.num_heads * cfg.head_dim \
        * (S * (S + 1) // 2) * cfg.num_layers
    assert chip_smoke.train_flops(cfg, n, B, S) == 6.0 * n * B * S + attn


def test_train_flops_of_qwen3_moe_235b_at_one_layer():
    """qwen3-moe-235b-a22b at 1 of 94 layers, B 4 x 512 (phase 10): a
    token runs the attention projections (64 query heads over 4), the
    q/k and block norms, the router, 8 of the 128 experts, the final
    norm and the untied 152064-row head's product; the embedding table
    beside it is a gather and the 120 unrouted experts do nothing.
    Attention: all causal pairs."""
    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b"),
                              num_layers=1)
    d, H, KV, hd, V = 4096, 64, 4, 128, 152064
    E, k, f, B, S = 128, 8, 1536, 4, 512
    layer = (d * H * hd + 2 * d * KV * hd + H * hd * d   # q, k, v, o
             + 2 * hd + 2 * d                          # q/k and block norms
             + d * E + k * 3 * d * f)                  # router, 8 experts
    used = layer + d + d * V                           # final norm, head
    n = _params(cfg)
    assert n == 3_733_467_392
    assert n - used == V * d + (E - k) * 3 * d * f
    attn = 3 * 4 * B * H * hd * (S * (S + 1) // 2)
    assert chip_smoke.train_flops(cfg, n, B, S) == 6 * used * B * S + attn
    assert round(chip_smoke.train_flops(cfg, n, B, S) / 1e12, 3) == 10.443


@pytest.mark.parametrize("arch", sorted(chip_smoke.DRYRUN_PEAK_GIB))
def test_printed_dryrun_peak_is_the_tools(arch):
    """The peak that phase 10 prints beside the card's reading is what
    the dry run gives today at the path's config (a meta trace, ~8 s)."""
    mem = zoo_train_peaks.trainer_memory(arch)
    gib = (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]) / 2**30
    assert round(gib, 2) == chip_smoke.DRYRUN_PEAK_GIB[arch]


def _tree():
    gen = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn(3, 5, generator=gen),
                       "b": torch.randn(7, generator=gen).bfloat16()},
            "opt": {"step": torch.tensor(12, dtype=torch.int64),
                    "m": torch.randn(2, 2, 2, generator=gen)}}


def test_fingerprint_of_equal_trees_is_equal():
    a, b = _tree(), _tree()
    assert a is not b
    fa = chip_smoke.fingerprint(a)
    assert fa == chip_smoke.fingerprint(b)
    assert set(fa) == {"params/w", "params/b", "opt/step", "opt/m"}
    assert fa["params/b"][:2] == ("torch.bfloat16", (7,))


@pytest.mark.parametrize("leaf", ["params/w", "params/b", "opt/step",
                                  "opt/m"])
@pytest.mark.parametrize("bit", [0, 9, 15])
def test_fingerprint_shows_one_flipped_bit_in_any_leaf(leaf, bit):
    """One bit of the first or the last element, in an f32, a bf16 or an
    int64 leaf: each of the leaf's sums moves, and no other leaf's."""
    want = chip_smoke.fingerprint(_tree())
    for i in (0, -1):
        tree = _tree()
        part, name = leaf.split("/")
        t = tree[part][name]
        flat = t.reshape(-1).view({2: torch.int16, 4: torch.int32,
                                   8: torch.int64}[t.element_size()])
        flat[i] ^= 1 << bit
        got = chip_smoke.fingerprint(tree)
        assert got[leaf][2] != want[leaf][2]
        assert got[leaf][3] != want[leaf][3]
        assert got[leaf][4] != want[leaf][4]
        assert {k: v for k, v in got.items() if k != leaf} == {
            k: v for k, v in want.items() if k != leaf}


def test_fingerprint_across_chunks_tells_a_swap(monkeypatch):
    """Two elements swapped leave the plain sum and move the weighted
    one, also when they lie in different chunks."""
    monkeypatch.setattr(chip_smoke, "FP_CHUNK", 2)
    t = torch.arange(5, dtype=torch.float32)
    swapped = t[[0, 1, 4, 3, 2]]
    a, b = (chip_smoke.fingerprint({"x": x})["x"] for x in (t, swapped))
    assert a[2] == b[2] and a[3] != b[3] and a[4] != b[4]
    monkeypatch.setattr(chip_smoke, "FP_CHUNK", 1 << 24)
    assert chip_smoke.fingerprint({"x": t})["x"] == a


@pytest.mark.parametrize("at", [0, 3, 1000])
def test_fingerprint_tells_a_change_that_cancels_its_linear_sums(at):
    """Three elements moved by +1, -2, +1 in their raw bits leave the
    plain and the weighted sum as they were (1·w - 2·(w + 2) + (w + 4) =
    0); the mixed sum moves."""
    t = torch.randn(1024, generator=torch.Generator().manual_seed(1))
    u = t.clone()
    u.view(torch.int32)[at:at + 3] += torch.tensor([1, -2, 1],
                                                   dtype=torch.int32)
    a, b = (chip_smoke.fingerprint({"x": x})["x"] for x in (t, u))
    assert a[2:4] == b[2:4] and a[4] != b[4]
