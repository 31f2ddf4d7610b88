"""The MoE's expert weights on a mesh stay sharded over "model" (CPU,
gloo ranks).

``layers.fsdp_gather`` gathers a block's weights over the fsdp axes only
for the expert weights, as the reference's ``fsdp_gather`` drops only the
"embed" axis: under expert parallelism each rank holds its experts, under
expert-TP its d_ff shard of every expert, and never every expert whole.
granite's smoke config (4 experts, d_ff 192) takes a train step on an
expert-parallel mesh (data 2, model 2) and an expert-TP mesh (data 1,
model 3) and on one device, from the same weights and batch:

- the expert weights the MoE's ``shard_map`` body is handed are this
  rank's part ([E/2, D, F] under EP, [E, D, F/3] under expert-TP);
- the loss, the gradient norm and every first moment after the step (the
  gradient scaled by 1 - b1) against the one-device step's within 1e-5 of
  the value (of each leaf's largest magnitude; float32 sums in other
  orders), with the load-balance loss weighed 0.  Its weight 0.01 is left
  out because on a mesh it is the mean of each shard's (the reference's
  ``pmean``), not the whole batch's, which moves the attention and router
  moments by ~1e-3 of their largest; ``test_torch_mesh_train.py``'s
  families test holds the steps with it.
"""
import numpy as np
import pytest

import _torch_mesh_ranks as ranks
from repro_torch.configs import get_config

D_FF = 192
MESHES = {"ep": (2, 2), "tp": (1, 3)}
TOL = 1e-5
AUX_WEIGHT = 0.0


@pytest.fixture(scope="module", params=sorted(MESHES))
def run(request, tmp_path_factory):
    shape = MESHES[request.param]
    return request.param, ranks.run(
        "moe_train", shape[0] * shape[1],
        tmp_path_factory.mktemp(request.param), mesh=shape, d_ff=D_FF,
        aux_weight=AUX_WEIGHT)


def test_expert_weights_reach_the_moe_as_this_ranks_part(run):
    mode, got = run
    cfg = get_config("granite-moe-3b-a800m").smoke()
    E, D, model = cfg.num_experts, cfg.d_model, MESHES[mode][1]
    want = ([(E // model, D, D_FF)] * 2 + [(E // model, D_FF, D)]
            if mode == "ep" else
            [(E, D, D_FF // model)] * 2 + [(E, D_FF // model, D)])
    for r, g in enumerate(got):
        assert int(g["moe_calls"]) > 0, r
        assert [tuple(s) for s in g["expert_shapes"].tolist()] == want, r


def test_moe_train_step_on_a_mesh_matches_one_device(run):
    _, got = run
    for r, g in enumerate(got):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(g[f"mesh/{k}"]),
                                       float(g[f"one/{k}"]), rtol=TOL,
                                       err_msg=f"rank {r} {k}")
        names = [k[len("one/mu/"):] for k in g if k.startswith("one/mu/")]
        assert names
        for n in names:
            a = g[f"one/mu/{n}"].numpy()
            np.testing.assert_allclose(
                g[f"mesh/mu/{n}"].numpy(), a, rtol=0,
                atol=TOL * np.abs(a).max(), err_msg=f"rank {r} {n}")
