from .library import fib_chain, inner_product, mul_chain, poly_eval  # noqa: F401
