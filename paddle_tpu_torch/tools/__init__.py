"""Operational tools: the cluster launcher (`cluster_launch`).  The JAX
package's other CLIs wait with ROADMAP A10."""
