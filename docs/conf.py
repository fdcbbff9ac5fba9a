"""Sphinx configuration for the ntracer_tpu docs.

The reference ships a Sphinx doc build (/root/reference/doc/conf.py);
this is its analog over this package's markdown docs.  Sphinx is not
a dependency, so the build is optional:

    pip install sphinx myst-parser && sphinx-build -b html docs docs/_build

API.md / EXAMPLES.md remain readable as plain markdown without it.
"""

import os
import sys

sys.path.insert(0, os.path.abspath(".."))

project = "ntracer_tpu"
author = "ntracer_tpu contributors"
release = "0.1"

extensions = ["sphinx.ext.autodoc"]
try:  # markdown sources via MyST when available
    import myst_parser  # noqa: F401
    extensions.append("myst_parser")
    source_suffix = {".rst": "restructuredtext", ".md": "markdown"}
except ImportError:
    source_suffix = {".rst": "restructuredtext"}

master_doc = "index"
exclude_patterns = ["_build"]
html_theme = "alabaster"
