from repro_torch.configs.registry import (ASSIGNED, get_config, list_archs,
                                    reduced_config, register)

__all__ = ["ASSIGNED", "get_config", "list_archs", "reduced_config",
           "register"]
