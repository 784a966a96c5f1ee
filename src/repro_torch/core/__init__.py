# The paper's system in the port: control plane copied verbatim from
# repro.core (constants, cost_model, predicate, chunk_store), array work in
# torch (merge, splice, routing).
