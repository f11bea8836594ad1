"""A rank worker for tests/test_torch_parallel.py that imports no JAX, so
the spawned ranks never import a JAX test module.

:func:`train_and_count_rank` runs scripts/sharded.py:train_rank, then one
probe loss and its backward on the 1-D COO ring with and without remat,
counting the calls of the plain versions that the kernels replace on the
card (B4's forward ``typed_segment._tns_fwd``, the ring SpMM
``parallel.ring.ring_spmm``), as tests/test_torch_checkpoint.py counts
them on one device, and of the sum over ranks
(``collectives.all_reduce_plain``: the psums' forwards and backwards).
"""

import pytest

from tip_tpu_torch import convert
from tip_tpu_torch.ops import typed_segment
from tip_tpu_torch.parallel import collectives, make_mesh, place_graph, ring
from tip_tpu_torch.scripts import sharded
from tip_tpu_torch.train.model import TIP, make_graph_arrays

COUNTED = {"tns_fwd": (typed_segment, "_tns_fwd"),
           "ring_spmm": (ring, "ring_spmm"),
           "all_reduce": (collectives, "all_reduce_plain")}


def count_recompute(rank: int, world: int, job) -> dict:
    """{remat: (calls after the forward, calls after the backward)} on this
    rank, each a {name: calls} of :data:`COUNTED`."""
    mesh = make_mesh(world, device_type=job.device)
    data = sharded.load_data(job)
    graph0, gs0 = make_graph_arrays(data, "cpu", dense_dtype=None, **job.pack)
    rgraph, rgs = sharded.sharded_graph(data, graph0, gs0, world, world, "coo")
    graph = place_graph(rgraph, mesh, rgs)
    model = TIP(cfg=job.cfg, gs=rgs, device=mesh.device)
    calls = dict.fromkeys(COUNTED, 0)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, (module, attr) in COUNTED.items():
            def counted(*args, _fn=getattr(module, attr), _name=name, **kw):
                calls[_name] += 1
                return _fn(*args, **kw)

            mp.setattr(module, attr, counted)
        for remat in (False, True):
            params = convert.params_from_jax(job.params, requires_grad=True)
            calls.update(dict.fromkeys(COUNTED, 0))
            loss = model.loss(params, graph, seed=0, mesh=mesh, remat=remat)
            fwd = dict(calls)
            loss.backward()
            out[remat] = (fwd, dict(calls))
    mesh.close()
    return out


def train_and_count_rank(rank: int, world: int, job) -> list:
    """train_rank's results, then :func:`count_recompute`'s."""
    return sharded.train_rank(rank, world, job) + [
        count_recompute(rank, world, job)]
