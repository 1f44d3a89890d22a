"""The data axis of the parallel stack (``srcgan_tpu.parallel``): a mesh of
processes, one device each, and the data-parallel, ZeRO-1 and FSDP steps
over it.  The space and model axes (``make_spatial_infer``,
``make_cas_2d_step``, tensor and pipeline parallelism) come with the rest of
ROADMAP A14; the JAX names that return sharding annotations (``replicated``,
``batch_sharding``, ``spatial_sharding``) have no tensor meaning here:
``put_replicated`` and ``put_batch`` do what the steps need of them."""
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
    make_cas_dp_step,
    make_cas_dp_steps_u8,
    make_cyclegan_dp_steps,
    make_gan_dp_iteration,
    pool_query,
)
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

__all__ = [
    "Mesh", "all_gather_batch", "destroy_mesh", "launch", "make_mesh", "pad_batch_to",
    "put_batch", "put_replicated", "shard_of", "make_cas_dp_step", "make_cas_dp_steps_u8",
    "make_cyclegan_dp_steps", "make_gan_dp_iteration", "pool_query", "ShardedAdam",
    "make_cas_zero1_step", "make_cas_zero1_steps_u8", "make_gd_zero1_step", "plain_state",
    "zero1_from_state", "zero1_gd_from_state", "zero1_gd_put", "zero1_init",
    "zero1_opt_bytes_per_device", "zero1_put", "fsdp_from_state", "fsdp_full_params",
    "fsdp_init", "fsdp_put", "fsdp_state_bytes_per_device", "gathered", "make_cas_fsdp_step",
    "make_cas_fsdp_steps_u8",
]
