"""The multichip dry run on 16 ranks (the counterpart of
``tests/test_models_and_parallel.py::test_dryrun_multichip_generalizes_to_16_devices``).

16 gloo ranks on the CPU (``tests/torch_mesh_worker.py``'s ``FileStore``
pattern, ``case_dryrun`` with no inputs: the port's parameters and batches
from its seeds) run ``accvlab_tpu_torch.dryrun_multichip``'s stanzas on
``mesh_shapes(16)``. Every rank's loss of every stanza lies within the
8-rank test's tolerance of the same step unsharded
(``dryrun_multichip.reference_loss`` at 16 devices' batches), and the
stanzas' lines name ``composed dp x pp x tp: mesh 4x2x2``, as JAX's test
asks. A hang guard of 300 s bounds the run; every rank is killed before the
test returns.
"""

import numpy as np
import pytest
import torch

from accvlab_tpu_torch import dryrun_multichip as D
from test_torch_dryrun import BF16_LOSS, FSDP_LOSS, MOE_LOSS, PP_LOSS
from torch_mesh_worker import run_ranks

WORLD = 16
HANG_GUARD_S = 300.0
# the 8-rank test's tolerance on each stanza's loss
RTOL = {"dp_tp": BF16_LOSS, "petr": BF16_LOSS, "input_pipeline": BF16_LOSS, "moe": MOE_LOSS,
        "pp": PP_LOSS, "pp_tp": PP_LOSS, "fsdp": FSDP_LOSS}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_sixteen_ranks_dryrun_stanzas_match_unsharded(tmp_path):
    outs = run_ranks("dryrun", WORLD, str(tmp_path), timeout=HANG_GUARD_S)
    assert len(outs) == WORLD
    shapes = D.mesh_shapes(WORLD)
    want = {name: D.reference_loss(name, WORLD, "cpu") for name in D.STANZAS}
    for o in outs:
        for name in D.STANZAS:
            assert o[f"{name}/mesh"].tolist() == list(shapes[name][0]), name
            loss = float(o[f"{name}/loss"])
            assert np.isfinite(loss), name
            np.testing.assert_allclose(loss, want[name], rtol=RTOL[name], err_msg=name)
    lines = [D.stanza_line(name, {"loss": float(outs[0][f"{name}/loss"]),
                                  "mesh": dict(zip(shapes[name][1],
                                                   outs[0][f"{name}/mesh"].tolist()))})
             for name in D.STANZAS]
    text = "\n".join(lines)
    assert "composed dp x pp x tp: mesh 4x2x2 (data x pipe x model)" in text, text
    assert "pipeline-parallel: mesh 4x4 (data x pipe)" in text, text
