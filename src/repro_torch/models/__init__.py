# Model layers of the port: MLA (absorbed decode and prefill), GQA
# attention, MoE, Mamba2 and the model assembly of every family, in serving
# and train form.
