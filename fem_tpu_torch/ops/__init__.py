"""Device stages of the mapping step, as plain functions on tensors."""
