"""Gluon losses (counterpart of ``incubator_mxnet_tpu/gluon/loss.py``).

Every loss of the JAX build, composed from registry ops as in the JAX build:
``sample_weight`` broadcasting, a ``batch_axis``-aware mean, the
``sparse_label``/``from_logits``/``from_sigmoid`` switches.
"""
from __future__ import annotations

from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss"]


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    """ref: loss.py _apply_weighting."""
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None:
        if not isinstance(weight, (int, float)):
            raise TypeError("weight must be a number, got %r" % (weight,))
        loss = loss * weight
    return loss


def _reshape_like(F, x, y):
    return x.reshape(y.shape)


class Loss(HybridBlock):
    """Base loss (ref: loss.py class Loss)."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        s = "{name}(batch_axis={_batch_axis}, w={_weight})"
        return s.format(name=self.__class__.__name__, **self.__dict__)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class L2Loss(Loss):
    """0.5·(pred - label)², averaged over all but the batch axis (ref:
    loss.py class L2Loss)."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.square(pred - label)
        loss = _apply_weighting(F, loss, self._weight / 2, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class L1Loss(Loss):
    """|pred - label|, averaged over all but the batch axis (ref: loss.py
    class L1Loss)."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.abs(pred - label)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


def _logistic(F, pred, label):
    """max(x, 0) - x·z + log(1 + exp(-|x|)): binary cross-entropy of
    logits, stable for either sign."""
    return F.relu(pred) - pred * label + \
        F.Activation(-F.abs(pred), act_type="softrelu")


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy (ref: loss.py class
    SigmoidBinaryCrossEntropyLoss): of logits, or of probabilities with
    ``from_sigmoid`` (log(p + 1e-12) terms)."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        if not self._from_sigmoid:
            loss = _logistic(F, pred, label)
        else:
            eps = 1e-12
            loss = -(F.log(pred + eps) * label
                     + F.log(1. - pred + eps) * (1. - label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """-log softmax(pred)[label] per sample (ref: loss.py class
    SoftmaxCrossEntropyLoss): ``sparse_label`` picks the label's entry along
    ``axis``, else a dense label weights every entry; ``from_logits`` takes
    ``pred`` as log-probabilities already."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            label = _reshape_like(F, label, pred)
            loss = -F.sum(pred * label, axis=self._axis, keepdims=True)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """label·(log(label + 1e-12) - pred), ``pred`` log-probabilities (or
    logits, ``from_logits=False``) (ref: loss.py class KLDivLoss)."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        loss = label * (F.log(label + 1e-12) - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class CTCLoss(Loss):
    """Connectionist temporal classification (ref: loss.py class CTCLoss,
    over the ``CTCLoss`` op).  ``pred`` holds ``layout`` (``NTC`` or
    ``TNC``) activations, ``label`` is ``label_layout`` (``NT`` or ``TN``)
    class ids padded with 0 (blank 0); ``pred_lengths`` and
    ``label_lengths``, where given, are each sample's lengths."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        assert layout in ["NTC", "TNC"], \
            "Only 'NTC' and 'TNC' layouts for pred are supported. Got: %s" \
            % layout
        assert label_layout in ["NT", "TN"], \
            "Only 'NT' and 'TN' layouts for label are supported. Got: %s" \
            % label_layout
        self._layout = layout
        self._label_layout = label_layout
        super().__init__(weight, label_layout.find("N"), **kwargs)

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        if self._layout == "NTC":
            pred = F.swapaxes(pred, dim1=0, dim2=1)
        if self._batch_axis == 1:
            label = F.swapaxes(label, dim1=0, dim2=1)
        kw = {}
        if pred_lengths is not None:
            kw.update(data_lengths=pred_lengths, use_data_lengths=True)
        if label_lengths is not None:
            kw.update(label_lengths=label_lengths, use_label_lengths=True)
        loss = F.CTCLoss(pred, label, **kw)
        return _apply_weighting(F, loss, self._weight, sample_weight)


class HuberLoss(Loss):
    """|d| - rho/2 above ``rho``, d²/(2·rho) below (ref: loss.py class
    HuberLoss)."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.abs(pred - label)
        loss = F.where(loss > self._rho, loss - 0.5 * self._rho,
                       (0.5 / self._rho) * F.square(loss))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class HingeLoss(Loss):
    """max(0, margin - pred·label) (ref: loss.py class HingeLoss)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.relu(self._margin - pred * label)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class SquaredHingeLoss(Loss):
    """max(0, margin - pred·label)² (ref: loss.py class SquaredHingeLoss)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.square(F.relu(self._margin - pred * label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class LogisticLoss(Loss):
    """log(1 + exp(-pred·label)) for labels in {-1, 1} (``signed``) or
    {0, 1} (``binary``) (ref: loss.py class LogisticLoss)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format
        if self._label_format not in ["signed", "binary"]:
            raise ValueError("label_format can only be signed or binary, "
                             "recieved %s." % label_format)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = _logistic(F, pred, label)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class TripletLoss(Loss):
    """max(‖a - p‖² - ‖a - n‖² + margin, 0) over all but the batch axis
    (ref: loss.py class TripletLoss)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative):
        positive = _reshape_like(F, positive, pred)
        negative = _reshape_like(F, negative, pred)
        loss = F.sum(F.square(pred - positive) - F.square(pred - negative),
                     axis=self._batch_axis, exclude=True)
        loss = F.relu(loss + self._margin)
        return _apply_weighting(F, loss, self._weight, None)
