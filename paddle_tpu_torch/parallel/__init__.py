"""The parallel layer of the port (``paddle_tpu/parallel/``): meshes over
``torch.distributed`` ranks, batch and weight placement, ZeRO-1, the
mixture-of-experts dispatch, the GPipe pipeline, ring and Ulysses
attention, the row-sharded sparse tables (``sparse.py``) and local SGD.
Tensor-parallel serving lives with the engine
(``ServingEngine(mesh=, tp_axis=)``, ``FleetRouter.over_mesh_slices``)."""

from paddle_tpu_torch.parallel.mesh import (Mesh, make_mesh,
                                            data_parallel_mesh, hybrid_mesh,
                                            mesh_slices, mesh_axis_names)
from paddle_tpu_torch.parallel.api import (shard_batch, replicate,
                                           param_sharding, DataParallel)
from paddle_tpu_torch.parallel.placement import (stage_attrs,
                                                 model_parallel_fc,
                                                 model_parallel_mlp)
from paddle_tpu_torch.parallel.pipeline import (PipelineConfig,
                                                pipeline_apply,
                                                stack_stage_params)
from paddle_tpu_torch.parallel.moe import (MoEConfig, MoEParams,
                                           init_moe_params, moe_ffn,
                                           moe_ffn_reference)
from paddle_tpu_torch.parallel.zero import (ZeroPlan, build_zero_plan,
                                            opt_state_bytes_per_device)
from paddle_tpu_torch.parallel.ring import ring_attention, ulysses_attention
from paddle_tpu_torch.parallel.local_sgd import LocalSGD
