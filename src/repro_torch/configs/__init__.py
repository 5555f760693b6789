"""Model configurations of the port (``repro_torch.configs.base``)."""
