"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``gpu``: each test decides in its body whether a CUDA card is
present and skips itself otherwise (so every pytest worker collects the
same tests).  On a machine with a card and the CUDA toolkit, run

    python -m pytest tests/test_torch_kernels.py -m gpu
"""

import pytest
import torch

from babble_tpu_torch import (
    DagConfig, assert_consensus_parity, batch_from_arrays, consensus_step,
    init_state, random_gossip_arrays,
)
from babble_tpu_torch.ops.ingest import _write_batch_fields
from babble_tpu_torch.ops.pallas_ingest import la_walk, la_walk_plain


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _walk_inputs(n, e, seed, dev, n_live=None):
    dag = random_gossip_arrays(n, e, seed=seed)
    cfg = DagConfig(n=n, e_cap=e, s_cap=max(64, dag.max_chain + 1), r_cap=64)
    st = _write_batch_fields(init_state(cfg, device=dev), cfg,
                             batch_from_arrays(dag, device=dev))
    ne = st.n_events if n_live is None else torch.tensor(
        n_live, dtype=torch.int32, device=dev)
    return (st.sp, st.op, st.creator, st.seq, ne, cfg.e_cap, cfg.n)


@pytest.mark.gpu
@pytest.mark.parametrize("n,e,seed,n_live", [
    (2, 64, 0, None), (4, 300, 1, None), (8, 1024, 13, 700),
    (33, 5000, 2, None), (64, 8192, 7, None),
])
def test_la_walk_kernel_matches_plain(n, e, seed, n_live):
    _need_card()
    args = _walk_inputs(n, e, seed, torch.device("cuda"), n_live)
    before = la_walk.launches
    got = la_walk(*args)
    torch.cuda.synchronize()
    assert la_walk.launches == before + 1
    want = la_walk_plain(*args)
    assert got.dtype == torch.int32 and got.shape == (e + 1, n)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_la_walk_kernel_rejects_mixed_devices():
    _need_card()
    args = list(_walk_inputs(4, 300, 1, torch.device("cuda")))
    args[1] = args[1].cpu()
    with pytest.raises(ValueError, match="op on cpu"):
        la_walk(*args)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["walk", "fast"])
def test_step_on_card_matches_cpu(mode):
    _need_card()
    dag = random_gossip_arrays(8, 1024, seed=13)
    cfg = DagConfig(n=8, e_cap=1024, s_cap=max(64, dag.max_chain + 1),
                    r_cap=64)
    ref = consensus_step(cfg, mode, init_state(cfg, device="cpu"),
                         batch_from_arrays(dag, device="cpu"))
    out = consensus_step(cfg, mode, init_state(cfg, device="cuda"),
                         batch_from_arrays(dag, device="cuda"))
    assert_consensus_parity(ref, out, cfg.e_cap, f"{mode} cpu vs card")
