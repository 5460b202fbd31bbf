"""The analysis stack: audit, standardize, PCA, K-Means, DBSCAN, t-SNE, UMAP."""
