# Launch layer: the operator entry points. The de-identification service
# launcher (``python -m repro_torch.launch.deid_service``), the LM serving
# launcher (``python -m repro_torch.launch.serve``) and the LM training
# launcher (``python -m repro_torch.launch.train``); the multi-card layer
# under them: the card's figures (``hw``), device meshes (``mesh``), the
# sharding rules and placing a model on a mesh (``shardings``), and the
# activation constraints the model code calls (``act_sharding``); and the
# multi-pod dry-run (``python -m repro_torch.launch.dryrun``), which traces
# every arch x shape x mesh cell on a fake world and reads the traced op
# stream with ``hlo_analysis`` (``OpTrace``, ``analyze_trace``,
# ``top_collectives``). Nothing is imported here: a submodule is imported
# where it is used, and importing the package starts no process group.
