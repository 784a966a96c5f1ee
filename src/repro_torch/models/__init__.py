# Model layers of the port: MLA (absorbed decode and prefill), MoE, Mamba2
# and the model assembly of their serving form.
