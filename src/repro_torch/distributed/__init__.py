"""Logical-axis sharding of the port on torch.distributed and DTensor
(`distributed.sharding`), the counterpart of `repro.distributed`."""
from repro_torch.distributed.sharding import (STRATEGIES, Strategy,
                                              make_sharder, pick_strategy,
                                              serve_strategy,
                                              train_strategy,
                                              train_strategy_fsdp,
                                              tree_shardings)

__all__ = ["Strategy", "make_sharder", "tree_shardings", "pick_strategy",
           "train_strategy", "train_strategy_fsdp", "serve_strategy",
           "STRATEGIES"]
