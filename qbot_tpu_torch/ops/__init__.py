# Submodules (core, gates, measurement) are imported directly to avoid
# circular imports with qbot_tpu_torch.basis; `from qbot_tpu_torch.ops import core` works.
