from .scalar import Fp, Fq3, P, GENERATOR, TWO_ADICITY, TWO_ADIC_ROOT_OF_UNITY, get_root_of_unity

__all__ = [
    "Fp",
    "Fq3",
    "P",
    "GENERATOR",
    "TWO_ADICITY",
    "TWO_ADIC_ROOT_OF_UNITY",
    "get_root_of_unity",
]
