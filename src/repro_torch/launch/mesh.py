"""Production meshes and the roofline constants — the port of
``repro.launch.mesh``.

Single pod: 16×16 = 256 devices, axes (data, model).
Multi-pod:  2×16×16 = 512 devices, axes (pod, data, model); the ``pod``
axis carries the data-parallel gradient all-reduce across pods.

The reference proves its meshes without hardware by faking 512 host
devices in XLA.  The port does the same with ``torch.distributed``'s
``fake`` backend: :func:`make_production_mesh` forms a world of 256 or
512 ranks in which this process is rank 0 and every collective returns
at once (its buffers unfilled), and builds a ``DeviceMesh`` over it.
DTensors of ``meta`` locals placed on that mesh carry each device's
shard shapes, and the dry run (:mod:`repro_torch.launch.dryrun`) counts
what one device computes and sends.  Both meshes are context managers
that own the world they make and destroy it on exit, as
``core.sharded_batched.make_players_group`` does, so no process group
outlives the block.

The reference's ``make_mesh_compat`` is a shim over jax versions and
has no counterpart.

The constants are the NVIDIA H100 SXM5 80 GB's, from its datasheet (at
its 700 W limit), per device: dense bf16 tensor-core peak, HBM3
bandwidth, NVLink bandwidth per direction, and shared memory per SM.
"""

from __future__ import annotations

import contextlib

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs.base import MeshConfig


@contextlib.contextmanager
def make_production_mesh(*, multi_pod: bool = False,
                         mesh_cfg: MeshConfig | None = None):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) ("pod",
    "data", "model") with ``multi_pod``, over a ``fake`` world of 256
    or 512 ranks on a ``FakeStore``.  The mesh's device type is
    ``cpu`` (a ``cuda`` mesh would make DTensor's sharding propagation
    build fake CUDA tensors, which a CPU-only torch cannot) and its
    tensors are meant to hold ``meta`` locals.  ``mesh_cfg``
    (the tests' small meshes) replaces the production shape.

    ``FakeStore`` comes from ``torch.testing._internal``, a private
    module of torch (imported here, when a mesh is made).  Refuses to
    run inside an initialised world: a fake world cannot share a
    process with a real one."""
    if dist.is_initialized():
        raise RuntimeError("a production mesh makes its own fake world; "
                           "torch.distributed is already initialised here")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    mcfg = mesh_cfg or MeshConfig(pod=2 if multi_pod else 1)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mcfg.num_devices)
    try:
        yield init_device_mesh("cpu", mcfg.shape,
                               mesh_dim_names=mcfg.axis_names)
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def make_host_mesh(model: int = 1, device=None):
    """The ("data", "model") mesh of what this host runs: (n // model,
    model) over the initialised world of n ranks (``torchrun``), else
    over a 1-rank world made here over an in-process ``HashStore`` and
    destroyed on exit.  On ``device`` (default ``cuda``, NCCL; each rank
    of a larger world on ``cuda:LOCAL_RANK``, as
    ``core.sharded_batched.rank_device`` picks it), or gloo on the
    CPU."""
    from repro_torch.core.sharded_batched import rank_device

    dev = rank_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    owned = not dist.is_initialized()
    if owned:
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    elif dist.get_backend() != backend:
        raise ValueError(f"the initialised world runs "
                         f"{dist.get_backend()}; a mesh on {dev} needs "
                         f"{backend}")
    try:
        n = dist.get_world_size()
        if n % model:
            raise ValueError(f"model={model} does not divide the world's "
                             f"{n} ranks")
        yield init_device_mesh(dev.type, (n // model, model),
                               mesh_dim_names=("data", "model"))
    finally:
        if owned:
            dist.destroy_process_group()


# NVIDIA H100 SXM5 80 GB constants for the roofline (per device)
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, dense
HBM_BW = 3.35e12                  # B/s
NVLINK_BW = 450e9                 # B/s per direction
SMEM_BYTES = 228 * 1024           # shared memory per SM
