# Launch layer: the operator entry points. The de-identification service
# launcher (``python -m repro_torch.launch.deid_service``), the LM serving
# launcher (``python -m repro_torch.launch.serve``) and the LM training
# launcher (``python -m repro_torch.launch.train``); and the multi-card
# layer under them: the card's figures (``hw``), device meshes (``mesh``),
# the sharding rules and placing a model on a mesh (``shardings``), and the
# activation constraints the model code calls (``act_sharding``).
