# One module per assigned architecture (deliverable f). Selected via
# ``--arch <id>`` through repro_torch.config.registry.
