__version__ = "0.1.0"

# Version of the c-ray feature set we implement (reference: src/c-ray.c:33)
REFERENCE_VERSION = "0.6.3"
