"""On the card only: the weights a run draws there repeat exactly, block by
block, as the reference draws them again after the program is freed."""

import json

import pytest
import torch

from perfbench.spec import HERE, architecture
from perfbench.weights import Weights, draw_block


@pytest.mark.cuda
def test_card_weights_repeat_block_by_block(cuda_device):
    hf = json.loads((HERE / "configs" / "qwen3_30b_a3b.json").read_text())["config"]
    arch = architecture(hf["model_type"])
    m = arch.dims(dict(hf, num_hidden_layers=2))
    w = Weights(arch, m, 2**31 + 3, cuda_device)
    for b in range(m.layers + 1):
        tree = w.params if b == 0 else w.params["layers"][b - 1]
        for name, t in draw_block(arch, m, 2**31 + 3, b, cuda_device).items():
            assert torch.equal(t, tree[name]), (b, name)
    assert w.params["layers"][0]["w_gate"].dtype == torch.bfloat16
