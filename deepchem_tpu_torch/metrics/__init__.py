from deepchem_tpu_torch.metrics.metric import (
    Metric, from_one_hot, handle_classification_mode, normalize_labels_shape,
    normalize_prediction_shape, normalize_weight_shape,
    threshold_predictions, to_one_hot)
from deepchem_tpu_torch.metrics.score_function import (
    accuracy_score, auc, balanced_accuracy_score, bedroc_score,
    cohen_kappa_score, concordance_index, f1_score, jaccard_index,
    jaccard_score, kappa_score, mae_score, matthews_corrcoef,
    mean_absolute_error, mean_squared_error, median_absolute_error,
    pearson_r2_score, pearsonr, pixel_error, prc_auc_score,
    precision_recall_curve, precision_score, r2_score, recall_score,
    rms_score, rmse, roc_auc_score, roc_curve, top_k_accuracy_score)

__all__ = [
    'Metric', 'from_one_hot', 'handle_classification_mode',
    'normalize_labels_shape', 'normalize_prediction_shape',
    'normalize_weight_shape', 'threshold_predictions', 'to_one_hot',
    'accuracy_score', 'auc', 'balanced_accuracy_score', 'bedroc_score',
    'cohen_kappa_score', 'concordance_index', 'f1_score', 'jaccard_index',
    'jaccard_score', 'kappa_score', 'mae_score', 'matthews_corrcoef',
    'mean_absolute_error', 'mean_squared_error', 'median_absolute_error',
    'pearson_r2_score', 'pearsonr', 'pixel_error', 'prc_auc_score',
    'precision_recall_curve', 'precision_score', 'r2_score',
    'recall_score', 'rms_score', 'rmse', 'roc_auc_score', 'roc_curve',
    'top_k_accuracy_score']
