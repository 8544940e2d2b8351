"""Launchers: the train driver. The mesh, dry-run and HLO tooling of the JAX
package are ROADMAP.md items 8 and 12."""
