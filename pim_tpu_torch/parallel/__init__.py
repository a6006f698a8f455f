"""Scale-out over a process world: pixel-sharded render and train steps and
the texel-sharded bake, one rank per process (`torch.distributed`).

  dist.py    the world (`init_distributed`, the PIM_* environment), the
             mesh record, row slices and host-side row gathers
  shard.py   `make_sharded_render_step`, `make_sharded_train_step`
  dryrun.py  `dryrun_multichip` and its launcher
             (python -m pim_tpu_torch.parallel.dryrun --ranks N)
"""
