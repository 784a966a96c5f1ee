# Model layers of the port: the absorbed MLA decode form and the rope subset.
