"""kinds"""
