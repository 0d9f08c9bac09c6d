"""The CLI's parts the apiserver serves from (a copy of the JAX package's
cli/explain.py: the field-documentation tree /openapi/v2 is built from).
The JAX package's kubectl and cluster bootstrap are not ported yet
(ROADMAP A17)."""
