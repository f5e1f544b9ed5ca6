"""``chip_smoke.py``'s arithmetic, on the CPU: the training step's
operation count that its MFU lines divide by, against hand counts."""
import dataclasses
import pathlib
import sys

import pytest

from repro_torch.configs import get_config
from repro_torch.core.device_plugin import flatten_with_paths
from repro_torch.models.lm import LM

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


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


def test_train_flops_of_a_tied_dense_model_is_unchanged():
    """qwen1.5-0.5b (tied embedding, no window): 6 per param per token
    plus all causal pairs, the count phase 3's MFU has always used."""
    cfg = get_config("qwen1.5-0.5b")
    n, B, S = _params(cfg), 4, 512
    attn = 3 * 4.0 * B * cfg.num_heads * cfg.head_dim \
        * (S * (S + 1) // 2) * cfg.num_layers
    assert chip_smoke.train_flops(cfg, n, B, S) == 6.0 * n * B * S + attn
