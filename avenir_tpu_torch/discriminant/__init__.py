"""Discriminants: the SMO support vector machine (``smo``) and the
univariate Fisher boundary (``fisher``)."""
