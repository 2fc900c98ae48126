from .tables import TABLE_REGISTRY, AeroTable, load_tables
from .train import assemble_stacked_weights, train_all, train_surrogate

__all__ = ["TABLE_REGISTRY", "AeroTable", "load_tables", "train_surrogate",
           "train_all", "assemble_stacked_weights"]
