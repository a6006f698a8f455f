"""Scale-out over a process world: pixel-sharded render and train steps and
the texel-sharded bake, one rank per process (`torch.distributed`).

  dist.py         the world (`init_distributed`, the PIM_* environment),
                  the mesh record, row and pixel slices and host-side row
                  gathers
  grad_reduce.py  `GradReducer`, the gradient average overlapped with the
                  backward, shared by both train steps on a mesh
  shard.py        `make_sharded_render_step`, `make_sharded_train_step`
                  (the JAX package's SGD counterpart of
                  `render/diff.py::make_train_step(..., mesh=)`, the
                  deployment's Adam step)
  dryrun.py       `dryrun_multichip` and its launcher
                  (python -m pim_tpu_torch.parallel.dryrun --ranks N)
"""
