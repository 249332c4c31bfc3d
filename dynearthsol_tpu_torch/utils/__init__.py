"""Host-side helpers (counterpart of dynearthsol_tpu/utils/)."""
