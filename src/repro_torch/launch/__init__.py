# Launch layer: the operator entry points. So far the de-identification
# service launcher (``python -m repro_torch.launch.deid_service``) and the
# LM serving launcher (``python -m repro_torch.launch.serve``).
