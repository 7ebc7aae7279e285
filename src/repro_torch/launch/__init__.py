# Launch layer: the operator entry points. The de-identification service
# launcher (``python -m repro_torch.launch.deid_service``), the LM serving
# launcher (``python -m repro_torch.launch.serve``) and the LM training
# launcher (``python -m repro_torch.launch.train``).
