from repro_torch.training.optimizer import (AdamWConfig, adamw_init_specs,
                                            adamw_update)

__all__ = ["AdamWConfig", "adamw_init_specs", "adamw_update"]
