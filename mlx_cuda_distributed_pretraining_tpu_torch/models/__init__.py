"""Model building blocks: the Llama decoder pieces and the MoE block."""
