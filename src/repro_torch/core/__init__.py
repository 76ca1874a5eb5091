"""EFMVFL core: protocols, GLM family, byte metering and the trainer."""
