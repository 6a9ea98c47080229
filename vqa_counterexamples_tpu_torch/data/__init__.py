"""Dataset views, synthetic fixtures and the feature store (numpy + torch)."""
