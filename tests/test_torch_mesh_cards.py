"""The mesh paths on 4 cards (``cuda`` marker; NCCL, a card a rank):
llama3-8b at full width, depth 2 in fp32, one train step at tp = 4 and at
(2, 2) against the one-card unsharded step (the loss within 1e-5
relative, each gradient leaf within 1e-4 of its largest |value|), then
depth 4 in bf16 at tp = 4 timed: the step's ms, tokens/s and the
collectives' device ms and kernels by kind on every rank (``-s`` prints
them as ``[mesh-cards]`` lines).  The child program is ``tests/torch_mesh_child.py``'s; the gloo
cases of the same program are in ``tests/test_torch_mesh.py``.
"""
import subprocess

import pytest

torch = pytest.importorskip("torch")

from torch_mesh_child import _spawn


@pytest.mark.cuda
def test_mesh_train_step_on_four_cards(tmp_path):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 NVIDIA GPUs (run on the cards)")
    ranks = _spawn(4, "cuda", tmp_path)
    res = ranks[0]
    for shape in ((1, 4), (2, 2)):
        loss, want, err = res[shape]
        print(f"[mesh-cards] {shape}: loss {loss!r} (one card {want!r}), "
              f"largest gradient error / leaf max {err:.3e}")
        assert abs(loss - want) <= 1e-5 * abs(want)
        assert err <= 1e-4
    t = res["timing"]
    print(f"[mesh-cards] bf16 depth 4 tp 4, 8 x 2048: step {t['step_ms']:.1f}"
          f" ms, {t['tokens_s']:.0f} tokens/s, loss {t['loss']:.4f}, peak "
          f"{t['peak_gb']:.2f} GB")
    for r, rank in enumerate(ranks):
        print(f"[mesh-cards] rank {r}: collectives (device ms, kernels) by "
              f"kind in one step {rank['timing']['coll_ms']}")
    print("[mesh-cards]", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout)



