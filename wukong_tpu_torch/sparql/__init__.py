"""Port subpackage (see wukong_tpu_torch/__init__.py)."""
