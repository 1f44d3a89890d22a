"""The parallel stack (``srcgan_tpu.parallel``): a mesh of processes, one
device each, over the ``data``, ``space``, ``model`` and ``pipe`` axes, and
the steps over it: data-parallel, ZeRO-1 and FSDP on ``data``; strips with
halo exchanges on ``space`` (``parallel.spatial``), the spatial inference and
the (data, space) step; tensor parallelism on ``model``; the pipelines on
``pipe``.  The JAX names that return sharding annotations (``replicated``,
``batch_sharding``, ``spatial_sharding``) have no tensor meaning here:
``put_replicated``, ``put_batch`` and the strip plans do what the steps need
of them."""
from srcgan_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_batch,
    destroy_mesh,
    launch,
    make_mesh,
    pad_batch_to,
    put_batch,
    put_replicated,
    shard_of,
)
from srcgan_tpu_torch.parallel.dp import (
    make_cas_2d_step,
    make_cas_2d_steps_u8,
    make_cas_dp_step,
    make_cas_dp_steps_u8,
    make_cyclegan_dp_steps,
    make_gan_dp_iteration,
    make_spatial_infer,
    pool_query,
)
from srcgan_tpu_torch.parallel.spatial import gather_strips, plan_strips, space_scope
from srcgan_tpu_torch.parallel.zero import (
    ShardedAdam,
    make_cas_zero1_step,
    make_cas_zero1_steps_u8,
    make_gd_zero1_step,
    plain_state,
    zero1_from_state,
    zero1_gd_from_state,
    zero1_gd_put,
    zero1_init,
    zero1_opt_bytes_per_device,
    zero1_put,
)
from srcgan_tpu_torch.parallel.fsdp import (
    fsdp_from_state,
    fsdp_full_params,
    fsdp_init,
    fsdp_put,
    fsdp_state_bytes_per_device,
    gathered,
    make_cas_fsdp_step,
    make_cas_fsdp_steps_u8,
)
from srcgan_tpu_torch.parallel.tp import (
    make_cas_tp_step,
    make_tp_infer,
    tp_param_shardings,
    tp_shard_params,
)
from srcgan_tpu_torch.parallel.pipeline import (
    make_cascade_pipeline_infer,
    make_rddb_trunk_pipeline_infer,
    make_trunk_pipeline_train,
    place_trunk_pipeline_params,
    stack_trunk_params,
)

__all__ = [
    "Mesh", "all_gather_batch", "destroy_mesh", "launch", "make_mesh", "pad_batch_to",
    "put_batch", "put_replicated", "shard_of", "make_cas_2d_step", "make_cas_2d_steps_u8",
    "make_cas_dp_step", "make_cas_dp_steps_u8", "make_cyclegan_dp_steps",
    "make_gan_dp_iteration", "make_spatial_infer", "pool_query", "gather_strips",
    "plan_strips", "space_scope", "ShardedAdam",
    "make_cas_zero1_step", "make_cas_zero1_steps_u8", "make_gd_zero1_step", "plain_state",
    "zero1_from_state", "zero1_gd_from_state", "zero1_gd_put", "zero1_init",
    "zero1_opt_bytes_per_device", "zero1_put", "fsdp_from_state", "fsdp_full_params",
    "fsdp_init", "fsdp_put", "fsdp_state_bytes_per_device", "gathered", "make_cas_fsdp_step",
    "make_cas_fsdp_steps_u8", "make_cas_tp_step", "make_tp_infer", "tp_param_shardings",
    "tp_shard_params", "make_cascade_pipeline_infer", "make_rddb_trunk_pipeline_infer",
    "make_trunk_pipeline_train", "place_trunk_pipeline_params", "stack_trunk_params",
]
