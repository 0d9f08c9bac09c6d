"""The CLI's parts the apiserver serves from (a copy of the JAX package's
cli/explain.py: the field-documentation tree /openapi/v2 is built from).
The JAX package's cli/cluster.py (the cluster bootstrap), cli/kubectl.py
and cli/__main__.py are not ported yet (ROADMAP A17)."""
