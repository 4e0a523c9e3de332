"""Model math of the port; the entry points live in ``models.transformer``."""
