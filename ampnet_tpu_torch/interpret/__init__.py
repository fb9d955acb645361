"""Interpretation suite (``ampnet_tpu/interpret`` in the port): curves and
history CSV, gradient and activation histograms, attention heatmaps, and
embedding plots. The numbers are numpy; matplotlib (and seaborn, networkx,
sklearn, umap where a plot uses them) is imported only when a plot is drawn."""
from ampnet_tpu_torch.interpret.attention import (
    attention_heatmaps,
    calculate_attn_heatmap,
    incoming_edge_attention,
    plot_attn_heatmap,
    plot_xor_attn_weights,
    top_k_features_for_class,
    visualize_attention_coefficients,
)
from ampnet_tpu_torch.interpret.curves import (
    history_to_csv,
    plot_acc_curves,
    plot_history,
    plot_loss_curves,
)
from ampnet_tpu_torch.interpret.embedding import (
    plot_pca_2d,
    plot_subgraph,
    plot_tsne_2d,
    plot_umap_2d,
)
from ampnet_tpu_torch.interpret.histograms import (
    activation_stages_from_aux,
    plot_grad_flow,
    visualize_activations,
    visualize_gradients,
)

__all__ = [
    "plot_loss_curves",
    "plot_acc_curves",
    "history_to_csv",
    "plot_history",
    "visualize_gradients",
    "plot_grad_flow",
    "visualize_activations",
    "activation_stages_from_aux",
    "top_k_features_for_class",
    "calculate_attn_heatmap",
    "plot_attn_heatmap",
    "visualize_attention_coefficients",
    "incoming_edge_attention",
    "plot_xor_attn_weights",
    "plot_pca_2d",
    "plot_umap_2d",
    "plot_tsne_2d",
    "plot_subgraph",
]
