"""Launchers: the train launcher, with its data mesh (``--mesh-hosts`` /
``RA_MESH_HOSTS``, DESIGN.md §15), the production meshes (``mesh``) and
the assigned input shapes (``shapes``). The dry-run and HLO tooling of the
JAX package are ROADMAP.md item 12."""
