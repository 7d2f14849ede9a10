"""Model substrate: layers, attention, SSM, MoE, transformer assembly."""

from repro_torch.models import attention, layers, moe, multimodal, ssm, transformer  # noqa: F401
