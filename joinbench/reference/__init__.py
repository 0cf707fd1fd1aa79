"""The plain reference: the join and the queries' group-by written again
from their semantics in plain PyTorch, the comparison that decides
``correct``, and the import checks. Nothing here imports the port, JAX or
the JAX package."""
