"""Scoring engine over the frozen-backbone caches."""
