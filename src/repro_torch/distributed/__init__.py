from repro_torch.distributed.sharding import (LONG_SERVE_BIG_RULES,
                                              LONG_SERVE_RULES,
                                              SERVE_BIG_RULES, SERVE_RULES,
                                              TRAIN_RULES, Mesh,
                                              NamedSharding, PartitionSpec,
                                              partition_spec,
                                              shardings_for_specs,
                                              shardings_for_tree)

__all__ = ["TRAIN_RULES", "SERVE_RULES", "LONG_SERVE_RULES",
           "SERVE_BIG_RULES", "LONG_SERVE_BIG_RULES", "Mesh",
           "NamedSharding", "PartitionSpec", "partition_spec",
           "shardings_for_specs", "shardings_for_tree"]
